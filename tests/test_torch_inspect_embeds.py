"""``python -m subspace_reg_tpu_torch.inspect_embeds`` prints what
``tools/inspect_embeds.py`` prints, line for line, on one seeded word
pickle (a zero vector among its entries) with labels that resolve, one
of two words missing and one missing altogether."""

import os
import pickle
import sys

import numpy as np

from subspace_reg_tpu_torch import inspect_embeds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_inspect_embeds_prints_the_jax_tools_summary(tmp_path, capsys):
    r = np.random.RandomState(3)
    words = {w: r.randn(500) for w in ("golden", "retriever", "organ",
                                       "house", "finch", "dugong")}
    words["zero"] = np.zeros(500)
    path = str(tmp_path / "miniImageNet_dim500.pickle")
    with open(path, "wb") as f:
        pickle.dump(words, f)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import inspect_embeds as jax_tool
    finally:
        sys.path.pop(0)
    argv = [path, "--vocab", "golden retriever", "organ", "house cat",
            "unicorn"]
    jax_tool.main(argv)
    want = capsys.readouterr().out
    inspect_embeds.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert "7 entries; dim=500" in got and "WARNING: 1 zero vectors" in got
    assert got.count("(OOV -> zero)") == 2
