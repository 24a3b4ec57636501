"""Subspace and semantic-subspace attractors (reference
models/resnet_language.py:20-97); the port's copy of the JAX package's
``models/lang_puller.py``.

The state is a small dataclass of tensors and every operation is a plain
function:
  * attractors  softmax(E_novel @ E_base^T / T) @ W_base     (:75-87)
  * loss1       gamma * ||attractor - W_novel||^2  (squared) (:89-90)
  * subspace projection via thin QR of W_base^T, including the
    (numerically no-op) division by column norms of Q          (:92-97)
  * GloVe mode slices the first 300 dims of the 500-d Vico vectors (:52-54)
  * synonyms mode reads a {label: embed} pickle                 (:35-42)
  * linear-mapping override: inspired = LinearMap(E_novel), no grad (:83-87)
  * ``use_descriptions`` reads BERT description embeds instead of the word
    embeds (the JAX package's live variant of the reference's dead path)
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .embeds import get_embeds, load_embed_pickle


@dataclass(frozen=True)
class LangPullerState:
    base_embeds: torch.Tensor                    # (n_base, d)
    novel_embeds: torch.Tensor                   # (n_novel, d)
    temperature: float = 1.0
    mapping_weight: Optional[torch.Tensor] = None   # (out, d) Linear layout
    mapping_bias: Optional[torch.Tensor] = None     # (out,)

    def replace(self, **changes) -> "LangPullerState":
        return dataclasses.replace(self, **changes)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _embed_path(word_embed_path: str, dataset: str, dim: int,
                synonyms: bool = False) -> str:
    suffix = "_base_synonyms" if synonyms else ""
    return os.path.join(word_embed_path,
                        f"{dataset}_dim{dim}{suffix}.pickle")


def description_embed_path(opt) -> str:
    """The description pickle's filename, the format string of reference
    util.py:95-99 (the shipped assets' naming, e.g.
    description_embeds/miniImageNet_bert-base-cased_layer6_prefix_True.pickle).
    """
    return os.path.join(
        opt.description_embed_path,
        "{0}_{1}_layer{2}_prefix_{3}.pickle".format(
            opt.dataset, opt.desc_embed_model, opt.transformer_layer,
            opt.prefix_label))


def _description_embeds(opt, vocab: Sequence[str]) -> np.ndarray:
    """Description embeds keyed by the full class name ({'house finch':
    vec(768), ...}): direct lookups, no per-word averaging.  Values may be
    torch tensors (the reference pickled tensors) or arrays."""
    d = load_embed_pickle(description_embed_path(opt))
    return np.stack([np.asarray(d[name], dtype=np.float32) for name in vocab],
                    0)


def create_lang_puller(opt, vocab_base: Sequence[str],
                       vocab_novel: Sequence[str]) -> LangPullerState:
    """Puller state from the word-embedding pickles (reference :21-54), or
    from the description pickles with ``opt.use_descriptions`` (used whole:
    the GloVe slice does not exist in the 768-d description space)."""
    if getattr(opt, "use_descriptions", False):
        return LangPullerState(
            base_embeds=_f32(_description_embeds(opt, vocab_base)),
            novel_embeds=_f32(_description_embeds(opt, vocab_novel)),
            temperature=float(opt.temperature))

    dim = opt.word_embed_size
    pth = _embed_path(opt.word_embed_path, opt.dataset, dim)
    novel = np.asarray(get_embeds(pth, vocab_novel, dim), np.float32)
    if opt.use_synonyms:
        syn = load_embed_pickle(
            _embed_path(opt.word_embed_path, opt.dataset, dim, synonyms=True))
        base = np.asarray(np.stack([np.asarray(syn[lbl])
                                    for lbl in vocab_base], 0), np.float32)
    else:
        base = np.asarray(get_embeds(pth, vocab_base, dim), np.float32)
    if opt.glove:
        # the first 300 dims of the saved embeds are GloVe (reference :52-54)
        base, novel = base[:, :300], novel[:, :300]
    return LangPullerState(base_embeds=_f32(base), novel_embeds=_f32(novel),
                           temperature=float(opt.temperature))


def update_novel_embeds(state: LangPullerState, opt,
                        vocab_novel: Sequence[str]) -> LangPullerState:
    """Swap in the next session's novel embeddings (reference :56-65)."""
    if getattr(opt, "use_descriptions", False):
        return state.replace(
            novel_embeds=_f32(_description_embeds(opt, vocab_novel)))
    dim = opt.word_embed_size
    pth = _embed_path(opt.word_embed_path, opt.dataset, dim)
    novel = np.asarray(get_embeds(pth, vocab_novel, dim), np.float32)
    if opt.glove:
        novel = novel[:, :300]
    return state.replace(novel_embeds=_f32(novel))


def with_mapping(state: LangPullerState, mapping_weight,
                 mapping_bias) -> LangPullerState:
    """Install the learned label->image LinearMap (reference :67-72);
    ``mapping_weight`` keeps the torch Linear layout (out_dim, in_dim)."""
    return state.replace(mapping_weight=_f32(mapping_weight),
                         mapping_bias=_f32(mapping_bias))


def _mapping_width_error(want: int, got: int) -> ValueError:
    return ValueError(
        f"mapping expects {want}-d label embeds but the puller holds "
        f"{got}-d ones; the LinearMap is trained on the GloVe slice "
        "(learn_mapping.py, --glove default), so the eval config must pass "
        "--glove too (reference slurm_linear_mapping.sh:53)")


def pullers(state: LangPullerState, base_weight: torch.Tensor,
            mask_diagonal: bool = False) -> torch.Tensor:
    """Semantic attractors in f32 (reference forward, :75-87),
    (n_novel, feat); no gradient flows into the mapping."""
    e_n = state.novel_embeds.to(base_weight.device)
    if state.mapping_weight is not None:
        w = state.mapping_weight.to(base_weight.device)
        if e_n.shape[1] != w.shape[1]:
            raise _mapping_width_error(w.shape[1], e_n.shape[1])
        out = e_n @ w.T
        if state.mapping_bias is not None:
            out = out + state.mapping_bias.to(base_weight.device)
        return out.detach()
    scores = e_n @ state.base_embeds.to(base_weight.device).T
    if mask_diagonal:
        n = min(scores.shape)
        idx = torch.arange(n, device=scores.device)
        scores = scores.clone()
        scores[idx, idx] = -9999.0
    probs = torch.softmax(scores / state.temperature, dim=1)
    return probs @ base_weight


def pullers_host_f64(state: LangPullerState,
                     base_weight: np.ndarray) -> np.ndarray:
    """The attractors in float64 on the host, rounded once to f32.  The
    engines use this per-session constant: every library rounds the same
    real number to the same float, so the port and the JAX package start
    K1 from the same target bits (an f32 value ~1e-5 off moves the
    stable-epoch stop at the golden epsilon)."""
    e_n = state.novel_embeds.numpy().astype(np.float64)
    if state.mapping_weight is not None:
        w = state.mapping_weight.numpy().astype(np.float64)
        if e_n.shape[1] != w.shape[1]:
            raise _mapping_width_error(w.shape[1], e_n.shape[1])
        out = e_n @ w.T
        if state.mapping_bias is not None:
            out = out + state.mapping_bias.numpy().astype(np.float64)
        return out.astype(np.float32)
    e_b = state.base_embeds.numpy().astype(np.float64)
    scores = (e_n @ e_b.T) / float(state.temperature)
    scores -= scores.max(axis=1, keepdims=True)
    p = np.exp(scores)
    p /= p.sum(axis=1, keepdims=True)
    return (p @ np.asarray(base_weight, np.float64)).astype(np.float32)


def pull_loss(gamma: float, inspired: torch.Tensor, weights: torch.Tensor,
              row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gamma * ||inspired - weights||^2 — SQUARED norm (reference loss1)."""
    d = inspired - weights
    if row_mask is not None:
        d = d * row_mask[:, None]
    return gamma * torch.sum(d * d)


def subspace_basis(base_weight: torch.Tensor) -> torch.Tensor:
    """The orthonormal basis Q (feat, n_base) of span(base rows): thin QR
    of W_base^T (reference get_projected_weight, :92-93)."""
    return torch.linalg.qr(base_weight.T)[0]


def project(q: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``weights`` projected onto span(Q): (W @ Q / colnorm(Q)) @ Q^T
    (reference :94-97).  The column-norm division is a numerical no-op
    kept for faithfulness."""
    mut = weights @ q                               # (k, n_base)
    colnorm = torch.linalg.norm(q.T, dim=1)         # == 1.0 per column
    return (mut / colnorm[None, :]) @ q.T


def projected_weight(base_weight: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Project ``weights`` onto span(base rows) (reference
    get_projected_weight, :92-97)."""
    return project(subspace_basis(base_weight), weights)
