"""flops.py against a hand count and against torch's own counter."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_tiny import ROOT
from benchmark import flops, harness
from benchmark.reference import backbone, resnet_rfs

STANDIN = ROOT / "benchmark/tests/standin_reference.py"


def test_one_rfs_block_by_hand():
    # stage 2 of resnet18 at 84 px: 64 -> 160 channels at 42 x 42
    convs = (64 * 160 * 9 + 160 * 160 * 9 + 160 * 160 * 9 + 64 * 160)
    assert flops.block_flops(64, 160, 42, 42, True) == 2 * 42 * 42 * convs
    assert flops.block_flops(320, 320, 10, 10, False) == \
        2 * 100 * 3 * 320 * 320 * 9


def test_resnet18_at_84px():
    cfg = harness.load_json(ROOT / "benchmark/configs/resnet18-mini84.json")
    sizes = [(b["cin"], b["cout"], b["h"]) for b in flops.blocks(cfg)]
    assert sizes == [(3, 64, 84), (64, 160, 42), (160, 320, 21),
                     (320, 320, 10), (320, 640, 10), (640, 640, 5)]
    assert flops.forward_flops(cfg) == 8_121_880_576
    step = flops.train_step_flops(cfg, 64, 60)
    assert abs(step / 1.559e12 - 1) < 1e-3


def _params(cfg, gen):
    p = {}
    for name, b in zip(resnet_rfs.block_names(cfg["n_blocks"]),
                       flops.blocks(cfg)):
        shapes = {"conv1": (b["cout"], b["cin"], 3, 3),
                  "conv2": (b["cout"], b["cout"], 3, 3),
                  "conv3": (b["cout"], b["cout"], 3, 3)}
        if b["shortcut"]:
            shapes["downsample.0"] = (b["cout"], b["cin"], 1, 1)
        for k, s in shapes.items():
            p[f"{name}.{k}.weight"] = torch.randn(s, generator=gen) * 0.1
        for bn in ("bn1", "bn2", "bn3") + (("downsample.1",)
                                           if b["shortcut"] else ()):
            p[f"{name}.{bn}.weight"] = torch.ones(b["cout"])
            p[f"{name}.{bn}.bias"] = torch.zeros(b["cout"])
            p[f"{name}.{bn}.running_mean"] = torch.zeros(b["cout"])
            p[f"{name}.{bn}.running_var"] = torch.ones(b["cout"])
        p[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return p


def test_against_torch_flop_counter():
    cfg = dict(harness.load_json(
        ROOT / "benchmark/configs/resnet18-mini84.json"),
        widths=[8, 16, 24, 32], img_size=24)
    p = _params(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(3, 3, 24, 24)
    with FlopCounterMode(display=False) as counter:
        resnet_rfs.forward(p, dict(p), x, cfg, train=False)
    assert counter.get_total_flops() == 3 * flops.forward_flops(cfg)


def test_k1_epoch_at_100_classes():
    # the last golden session: 185 support rows, 175 replay rows
    assert abs(flops.k1_epoch_flops(185, 175, 100, 640, 5) / 96.3e6 - 1) \
        < 1e-3


def test_the_resnet_found_by_name_is_the_resnet():
    """The forward that the configuration's ``reference`` names is
    ``resnet_rfs.forward`` bit for bit, in both modes, at the tiny sizes;
    so are its count and feature width."""
    cfg = harness.load_json(ROOT / "benchmark/configs/resnet18-mini84.json")
    found = backbone.of(cfg)
    cfg.update(found.TINY)
    p = _params(cfg, torch.Generator().manual_seed(3))
    x = torch.randn(6, 3, 16, 16, generator=torch.Generator().manual_seed(4))
    mask = (torch.arange(6) < 4).float()
    for train in (False, True):
        outs = []
        for fwd in (found.forward, resnet_rfs.forward):
            buf = {k: v.clone() for k, v in p.items()}
            gen = torch.Generator().manual_seed(5)
            outs.append((fwd(p, buf, x, cfg, train, gen, mask), buf))
        (a, buf_a), (b, buf_b) = outs
        assert torch.equal(a, b)
        assert all(torch.equal(buf_a[k], buf_b[k]) for k in buf_b)
    assert found.forward_flops(cfg) == flops.forward_flops(cfg)
    assert flops.feature_dim(cfg) == 80


def test_a_reference_counts_its_own_forward():
    """Another architecture's count, found through its configuration,
    against torch's own counter over its forward."""
    cfg = {"reference": str(STANDIN), "width": 16, "patch": 4, "heads": 2,
           "mlp": 24, "img_size": 16}
    gen = torch.Generator().manual_seed(0)
    shapes = {"patch_embed.weight": (16, 3, 4, 4), "patch_embed.bias": (16,),
              "cls_token": (1, 1, 16), "pos_embed": (1, 17, 16),
              "attn.in_proj_weight": (48, 16), "attn.in_proj_bias": (48,),
              "attn.out_proj.weight": (16, 16), "attn.out_proj.bias": (16,),
              "fc1.weight": (24, 16), "fc1.bias": (24,),
              "fc2.weight": (16, 24), "fc2.bias": (16,)}
    p = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    for n in ("norm1.", "norm2.", "norm."):
        p[n + "weight"], p[n + "bias"] = torch.ones(16), torch.zeros(16)
    with FlopCounterMode(display=False) as counter:
        backbone.of(cfg).forward(p, {}, torch.randn(3, 3, 16, 16), cfg,
                                 train=False)
    assert counter.get_total_flops() == 3 * flops.forward_flops(cfg)
