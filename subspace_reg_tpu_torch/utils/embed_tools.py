"""Embedding-asset materialization (reference util.py:53-130): the port's
copy of the JAX package's ``utils/embed_tools.py``, with the same lazy
imports, pickled schema, reuse of an existing pickle and
missing-dependency message.

``create_and_save_embeds``       -- per-word Vico vectors via torchnlp:
                                    ``{word: np.ndarray(dim)}``, the
                                    interchange format the attractors read.
``create_and_save_descriptions`` -- the WordNet definition of each class
                                    embedded by a masked LM's hidden layer
                                    (mean over tokens), via HuggingFace
                                    transformers: ``{class: np.ndarray(768)}``.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Sequence

import numpy as np


def create_and_save_embeds(opt, vocab: Sequence[str]) -> str:
    """Reference util.py:53-87.  Returns the pickle path (existing or
    new)."""
    word_embeds = opt.word_embed_path
    dim = opt.word_embed_size
    embed_pth = os.path.join(word_embeds,
                             "{0}_dim{1}.pickle".format(opt.dataset, dim))
    os.makedirs(word_embeds, exist_ok=True)
    if os.path.exists(embed_pth):
        print("Found {}.".format(embed_pth))
        return embed_pth

    words: List[str] = []
    for token in vocab:
        words = words + token.split(" ")
    try:
        from torchnlp.word_to_vector import Vico  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "torchnlp is not installed in this image; pre-generated "
            "word-embedding pickles (the reference ships "
            "word_embeds/miniImageNet_dim500.pickle) must be provided at "
            f"{embed_pth}") from e

    pretrained = Vico(name="linear", dim=dim,
                      is_include=lambda w: w in set(words))
    keys = pretrained.token_to_index.keys()
    d = {w: pretrained[w].numpy() for w in keys}
    with open(embed_pth, "wb") as f:
        pickle.dump(d, f)
    print("Pickled.")
    return embed_pth


def create_and_save_descriptions(opt, vocab: Sequence[str]) -> str:
    """Reference util.py:90-130: the WordNet first-synset definition of
    each class, embedded by a masked LM's hidden layer
    ``opt.transformer_layer`` (mean over tokens)."""
    os.makedirs(opt.description_embed_path, exist_ok=True)
    embed_pth = os.path.join(
        opt.description_embed_path,
        "{0}_{1}_layer{2}_prefix_{3}.pickle".format(
            opt.dataset, opt.desc_embed_model, opt.transformer_layer,
            opt.prefix_label))
    if os.path.exists(embed_pth):
        return embed_pth

    import torch
    from nltk.corpus import wordnet
    from transformers import AutoModelForMaskedLM, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(opt.desc_embed_model)
    model = AutoModelForMaskedLM.from_pretrained(
        opt.desc_embed_model, output_hidden_states=True)

    defs = [wordnet.synsets(v.replace(" ", "_"))[0].definition()
            for v in vocab]
    embeds = []
    with torch.no_grad():
        for i, d in enumerate(defs):
            inp = vocab[i] + " " + d if opt.prefix_label else d
            inp = tokenizer(inp, return_tensors="pt")
            outputs = model(**inp)
            hidden_states = outputs[1]
            embed = torch.mean(hidden_states[opt.transformer_layer],
                               dim=(0, 1))
            embeds.append(np.asarray(embed))

    with open(embed_pth, "wb") as f:
        pickle.dump(dict(zip(vocab, embeds)), f)
    return embed_pth
