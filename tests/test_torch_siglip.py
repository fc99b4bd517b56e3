"""SigLIP so400m/14 on the port's normal path, at a tiny size on the CPU.

The tiny preset (`siglip_tiny`) keeps what the full tower forces: heads
of 72 (K2's 80 instance on the card), a patch remainder (62 px at patch
14: the last 6 pixel rows and columns are cropped), no class token, the
MAP pooling head, tanh GELU and an MLP width that is no multiple of the
width. The port is held against the benchmark's plain float32 reference
(`benchmark/reference/siglip_vit.py`, `siglip_text.py`: one reference,
the cell's), with seeded weights drawn by the benchmark's own laws.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark import data, weights  # noqa: E402
from benchmark.builders import siglip_vit as builder  # noqa: E402
from benchmark.reference import siglip_text as ref_text  # noqa: E402
from benchmark.reference import siglip_vit as ref_vit  # noqa: E402
from mmrs_tpu_torch import config as port_config  # noqa: E402
from mmrs_tpu_torch import pipeline  # noqa: E402
from mmrs_tpu_torch.models import clip, configs, vit  # noqa: E402
from mmrs_tpu_torch.ops import attention, mlp_int8  # noqa: E402
from mmrs_tpu_torch.ops.dense_epilogue import act_name, gelu_tanh  # noqa: E402
from mmrs_tpu_torch.ops.preprocess import (CLIP_MEAN, CLIP_STD,  # noqa: E402
                                           normalize_images)
from mmrs_tpu_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
SIZE = configs.SIGLIP_TINY.image_size


@pytest.fixture(autouse=True)
def cpu_port(monkeypatch):
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")


def tiny_cfg() -> dict:
    """The cell's configuration file at the tiny preset's sizes."""
    with open(os.path.join(REPO, "benchmark", "configs",
                           "siglip-so400m-384.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["port"] = {"image_tower": "siglip_tiny",
                   "text_tower": "siglip_text_tiny"}
    v, t = configs.SIGLIP_TINY, configs.SIGLIP_TEXT_TINY
    cfg["image_tower"].update(image_size=v.image_size, width=v.width,
                              layers=v.layers, heads=v.heads,
                              mlp_width=v.mlp_width, embed_dim=v.embed_dim)
    cfg["text_tower"].update(vocab_size=t.vocab_size,
                             context_length=t.context_length, width=t.width,
                             layers=t.layers, heads=t.heads,
                             mlp_width=t.mlp_width, embed_dim=t.embed_dim)
    return cfg


def _pair(seed, dtype):
    cfg = tiny_cfg()
    w = weights.make(cfg, seed, CPU)
    return cfg, w, builder.build(cfg, w, CPU, dtype=dtype)


# -- the towers against the reference -----------------------------------------

# max over 16 images of the L2 gap between the port's unit rows and the
# reference's. float32: the same sums in another order (read 5.5e-7 -
# 1.1e-6 on seeds 1-3). bfloat16: one rounding of every activation and
# weight over two blocks and the head (read 0.0066-0.0103); the limit
# leaves 2.4x. The int8 tower reads 0.047-0.055, so it breaks the limit.
IMAGE_GAP = {"float32": 1e-5, "bfloat16": 0.025}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_image_tower_matches_the_reference(seed, dtype):
    cfg, w, towers = _pair(seed, dtype)
    imgs = data.image_pool(16, SIZE, seed, CPU)
    ref = ref_vit.encode(w, cfg["image_tower"], torch.from_numpy(imgs))
    got = towers.image_encode(imgs)
    assert got.shape == (16, configs.SIGLIP_TINY.width)
    gap = float(np.linalg.norm(got - ref.numpy(), axis=1).max())
    if dtype == "int8":
        assert gap > IMAGE_GAP["bfloat16"], gap
    else:
        assert gap <= IMAGE_GAP[dtype], gap


# float32 read 6.4e-7 - 9.6e-7; bfloat16 0.009-0.020 (two blocks of 16
# tokens, the head's bias added in f32), a limit of 1.75x the widest
TEXT_GAP = {"float32": 1e-5, "bfloat16": 0.035}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_tower_matches_the_reference(seed, dtype):
    cfg, w, towers = _pair(seed, dtype)
    spec = cfg["text_tower"]
    ids = torch.randint(0, spec["vocab_size"], (6, spec["context_length"]),
                        generator=torch.Generator().manual_seed(seed))
    ref = ref_text.encode(w, spec, ids)
    got = clip.encode_text(towers.params, ids,
                           pipeline._DTYPES[dtype])
    assert float((got - ref).norm(dim=1).max()) <= TEXT_GAP[dtype]


def test_text_tower_is_bidirectional_and_pools_the_last_token():
    cfg, w, towers = _pair(4, "float32")
    ids = torch.randint(0, 512, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    base = clip.encode_text(towers.params, ids, torch.float32)
    # a change at the first position reaches the last token (no causal
    # mask); a change of the last token moves the pooled row
    for pos in (0, 15):
        moved = ids.clone()
        moved[:, pos] = (moved[:, pos] + 1) % 512
        got = clip.encode_text(towers.params, moved, torch.float32)
        assert float((got - base).norm(dim=1).min()) > 1e-4


def test_the_reference_depends_on_every_published_piece():
    """Dropping the patch bias, the crop, the head's MLP or tanh GELU
    moves the reference: the tests above would catch a port without it."""
    cfg, w, _ = _pair(5, "float32")
    spec = cfg["image_tower"]
    imgs = torch.from_numpy(data.image_pool(4, SIZE, 5, CPU))
    base = ref_vit.encode(w, spec, imgs)
    for name in ("visual.patch_embed.bias", "visual.head.mlp.w2.weight",
                 "visual.head.probe"):
        changed = dict(w, **{name: torch.zeros_like(w[name])})
        assert float((ref_vit.encode(changed, spec, imgs)
                      - base).abs().max()) > 1e-4, name
    shifted = imgs.clone()
    shifted[:, -6:] = 255 - shifted[:, -6:]      # the cropped rows only
    assert torch.equal(ref_vit.encode(w, spec, shifted), base)


# -- the pieces ---------------------------------------------------------------

def test_the_presets_keep_todays_towers():
    for cfg, seq, hidden, act in ((configs.VIT_B32, 50, 3072, "quick_gelu"),
                                  (configs.VIT_L14, 257, 4096, "quick_gelu"),
                                  (configs.VIT_L14_336, 577, 4096,
                                   "quick_gelu")):
        assert (cfg.seq_len, cfg.hidden, cfg.act) == (seq, hidden, act)
        assert (cfg.pool, cfg.class_token, cfg.pre_norm, cfg.patch_bias,
                cfg.layer_norm_eps) == ("cls", True, True, False, 1e-5)
        assert (cfg.mean, cfg.std, cfg.stack) == (CLIP_MEAN, CLIP_STD,
                                                  "openai")
    assert configs.VITConfig(quick_gelu=False).act == "gelu"
    assert configs.CLIP_TEXT_B32.act == "quick_gelu"
    s = configs.SIGLIP_SO400M_384
    assert (s.grid, s.seq_len, s.hidden, s.act, s.width // s.heads) == (
        27, 729, 4304, "gelu_tanh", 72)
    with pytest.raises(ValueError, match="activation"):
        configs.VITConfig(activation="relu").act


@pytest.mark.parametrize("size,patch", [(224, 32), (224, 14), (336, 14)])
def test_patchify_is_unchanged_where_the_patch_divides_the_image(size,
                                                                  patch):
    x = torch.randn((2, size, size, 3),
                    generator=torch.Generator().manual_seed(size + patch))
    g = size // patch
    want = x.reshape(2, g, patch, g, patch, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(2, g * g, patch * patch * 3)
    assert torch.equal(vit.patchify(x, patch), want)


def test_patchify_crops_the_remainder_as_a_valid_conv():
    x = torch.randn((2, 384, 384, 3),
                    generator=torch.Generator().manual_seed(0))
    got = vit.patchify(x, 14)
    assert got.shape == (2, 729, 588)
    assert torch.equal(got, vit.patchify(x[:, :378, :378].contiguous(), 14))
    w = torch.randn((5, 3, 14, 14), generator=torch.Generator().manual_seed(1))
    conv = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, stride=14)
    mine = got @ w.permute(0, 2, 3, 1).reshape(5, -1).T
    assert torch.allclose(mine, conv.flatten(2).transpose(1, 2), atol=1e-4)


def test_mha_plan_pads_heads_of_72_to_80_and_keeps_the_others():
    bf16 = torch.bfloat16
    # hdp 80: Q tile and K/V ring rows of 88 bf16
    assert attention.mha_plan(729, 72, bf16) == ("mma", 128,
                                                 2 * (128 + 256) * 88)
    assert attention.mha_plan(64, 72, bf16) == ("mma", 64, 2 * (64 + 256) * 88)
    assert attention.mha_plan(40, 80, bf16).smem == 2 * (48 + 256) * 88
    # the plans B/32 and L/14 (hd 64) and hd 128 took before
    for (t, hd), plan in {(50, 64): ("mma", 64, 46080),
                          (257, 64): ("mma", 96, 50688),
                          (577, 64): ("mma", 128, 55296),
                          (50, 128): ("mma", 64, 87040),
                          (257, 128): ("mma", 96, 95744),
                          (577, 128): ("mma", 128, 104448)}.items():
        assert attention.mha_plan(t, hd, bf16) == plan
    assert attention.mha_plan(729, 72, torch.float32).route == "fma"


def test_pool_attention_is_the_rows_of_full_attention():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((3, 20, 144), generator=g).to(torch.bfloat16)
               for _ in range(3))
    full = attention.mha_short_seq(q, k, v, 2, impl="torch")
    before = attention.pool_attention.launches
    got = attention.pool_attention(q[:, 3:4], k, v, 2)
    assert attention.pool_attention.launches == before + 1
    assert got.shape == (3, 1, 144) and got.dtype == torch.bfloat16
    assert torch.allclose(got.float(), full[:, 3:4].float(), atol=1e-2)
    # plain ops on every device: there is no route to choose
    with pytest.raises(TypeError, match="impl"):
        attention.pool_attention(q[:, :1], k, v, 2, impl="torch")


def test_the_map_head_runs_once_an_encode_inside_its_span():
    _, _, towers = _pair(6, "bfloat16")
    imgs = data.image_pool(3, SIZE, 6, CPU)
    profiling.spans()
    before = attention.pool_attention.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        towers.image_encode(imgs)
    assert attention.pool_attention.launches == before + 1
    got, _ = profiling.spans()
    names = [s.name for s in got]
    assert names.count("towers.pool") == 1
    pool = next(s for s in got if s.name == "towers.pool")
    encode = next(s for s in got if s.name == "towers.encode")
    assert encode.start_ns <= pool.start_ns <= pool.end_ns <= encode.end_ns
    assert pool.items == 3


@pytest.mark.parametrize("mean,std", [((0.5,) * 3, (0.5,) * 3),
                                      (CLIP_MEAN, CLIP_STD)])
def test_normalize_takes_the_towers_mean_and_std(mean, std):
    x = torch.randint(0, 256, (2, 9, 7, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    got = normalize_images(x, torch.float32, mean=mean, std=std)
    m = torch.tensor(np.float32(mean))
    inv = torch.tensor(np.float32(1.0) / np.float32(std))
    assert torch.equal(got, (x.float() * (1.0 / 255.0) - m) * inv)
    assert torch.equal(normalize_images(x, torch.bfloat16, mean=mean, std=std),
                       got.to(torch.bfloat16))
    if mean == CLIP_MEAN:
        assert torch.equal(normalize_images(x, torch.float32), got)


def test_gelu_tanh_is_an_epilogue_and_an_int8_mlp_activation():
    assert act_name(gelu_tanh) == "gelu_tanh"
    x = torch.linspace(-6, 6, 97)
    assert torch.equal(gelu_tanh(x), torch.nn.functional.gelu(
        x, approximate="tanh"))


def test_padding_the_int8_mlps_hidden_units_changes_no_bit():
    """K6 takes SigLIP's H = 4304 padded to 4320 by zero units."""
    from mmrs_tpu_torch.models.layers import QLinear

    g = torch.Generator().manual_seed(7)
    w1 = QLinear.from_linear(_linear(64, 152, g))
    w2 = QLinear.from_linear(_linear(152, 64, g))
    x = torch.randn((9, 64), generator=g).to(torch.bfloat16)
    args = (w1.q, w1.s, w1.bias, w2.q, w2.s, w2.bias)
    want = mlp_int8._mlp_int8_torch(x, *args, "gelu_tanh")
    p1, ps, pb, p2 = mlp_int8.pad_hidden(w1.q, w1.s, w1.bias, w2.q)
    assert p1.shape == (160, 64) and p2.shape == (64, 160)
    got = mlp_int8._mlp_int8_torch(x, p1, ps, pb, p2, w2.s, w2.bias,
                                   "gelu_tanh")
    assert torch.equal(got, want)
    assert mlp_int8.pad_hidden(p1, ps, pb, p2)[0] is p1


def _linear(n_in, n_out, g):
    lin = torch.nn.Linear(n_in, n_out)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((n_out, n_in), generator=g) * 0.1)
        lin.bias.copy_(torch.randn(n_out, generator=g) * 0.1)
    return lin


# -- the pair on the normal path ---------------------------------------------

def _port_cfg(dtype="bfloat16"):
    model = dataclasses.replace(port_config.ModelConfig(),
                                image_tower="siglip_tiny",
                                text_tower="siglip_text_tiny", dtype=dtype)
    return dataclasses.replace(port_config.Config(), model=model)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_build_towers_builds_the_pair_and_build_index_indexes_through_it(
        tmp_path, dtype):
    from mmrs_tpu_torch.index.gallery import build_index

    towers = pipeline.build_towers(_port_cfg(dtype), device="cpu")
    assert isinstance(towers.params, clip.SigLIP)
    assert float(towers.params.logit_bias) == -10.0
    pool = data.image_pool(12, SIZE, 9, CPU)
    ids = data.stream_ids(12, 4, 9)
    stream = data.ImageStream(data.Samples(ids, 0, 12), pool)
    index = build_index(stream, towers.image_encode, str(tmp_path / "idx"),
                        batch_size=4, shard_rows=6)
    assert len(index) == 12 and index.dim == configs.SIGLIP_TINY.width
    want = towers.image_encode(pool[ids])
    np.testing.assert_allclose(np.asarray(index.embeddings, np.float32),
                               want, atol=2e-3)


def test_build_towers_takes_a_state_dict_as_its_weights():
    first = pipeline.build_towers(_port_cfg(), device="cpu")
    state = {k: v.clone() for k, v in first.params.state_dict().items()}
    again = pipeline.build_towers(_port_cfg(), device="cpu", weights=state)
    imgs = data.image_pool(2, SIZE, 1, CPU)
    assert np.array_equal(first.image_encode(imgs), again.image_encode(imgs))
    del state["visual.head.probe"]
    with pytest.raises(RuntimeError, match="head.probe"):
        pipeline.build_towers(_port_cfg(), device="cpu", weights=state)


def test_build_towers_names_an_unknown_tower():
    cfg = _port_cfg()
    cfg.model.image_tower = "siglip_giant"
    with pytest.raises(ValueError, match="siglip_giant"):
        pipeline.build_towers(cfg, device="cpu")


@pytest.mark.parametrize("text_tower", ["clip_text", "taiyi_roberta",
                                        "siglip_text_so400m"])
def test_build_towers_takes_the_siglip_text_tower_that_text_tower_names(
        text_tower):
    """The pair's text tower is `model.text_tower`'s, and a SigLIP one of
    the image tower's embed dim (the full tower's is 1152-d, not 144)."""
    cfg = _port_cfg()
    cfg.model.text_tower = text_tower
    with pytest.raises(ValueError, match="siglip_text_tiny"):
        pipeline.build_towers(cfg, device="cpu")


def test_the_int8_towers_mlps_are_padded_once_when_quantized():
    """K6 takes H in whole 32s: the int8 tower's MLPs (the blocks' and
    the MAP head's) hold H = 152 padded to 160 by zero units from
    quantization on, giving the bits of the unpadded layers; CLIP's whole
    widths stay as they were."""
    from mmrs_tpu_torch.models.layers import MLP, QLinear
    from mmrs_tpu_torch.models.quantize import quantize_tree

    towers = pipeline.build_towers(_port_cfg("int8"), device="cpu")
    mlps = [m for m in towers.params.visual.modules() if isinstance(m, MLP)]
    assert len(mlps) == configs.SIGLIP_TINY.layers + 1
    assert all(m.w1.q.shape == (160, 144) and m.w2.q.shape == (144, 160)
               for m in mlps)
    g = torch.Generator().manual_seed(3)
    mlp = MLP(64, 152, gelu_tanh)
    mlp.w1, mlp.w2 = _linear(64, 152, g), _linear(152, 64, g)
    w1, w2 = (QLinear.from_linear(lin) for lin in (mlp.w1, mlp.w2))
    quantize_tree(mlp)
    assert mlp.w1.q.shape == (160, 64)
    x = torch.randn((2, 5, 64), generator=g).to(torch.bfloat16)
    want = mlp_int8._mlp_int8_torch(x.reshape(10, 64), w1.q, w1.s, w1.bias,
                                    w2.q, w2.s, w2.bias, "gelu_tanh")
    assert torch.equal(mlp(x, torch.bfloat16, "torch").reshape(10, 64),
                       want)
    clip_mlp = quantize_tree(MLP(64, 256, gelu_tanh))
    assert clip_mlp.w1.q.shape == (256, 64)


def test_the_builder_stops_on_a_port_without_the_tower(monkeypatch):
    """A port that lacks the preset (an older tree) stops at once, naming
    the tower, before anything is built."""
    monkeypatch.delitem(configs.IMAGE_TOWERS, "siglip_tiny")
    with pytest.raises(ValueError, match="image tower 'siglip_tiny'"):
        builder.build(tiny_cfg(), {}, CPU)
    cfg = tiny_cfg()
    monkeypatch.setitem(configs.IMAGE_TOWERS, "siglip_tiny",
                        configs.SIGLIP_TINY)
    cfg["image_tower"]["mlp_width"] = 160
    with pytest.raises(ValueError, match="mlp_width"):
        builder.check_sizes(cfg)


def test_load_image_resizes_siglips_whole_image(tmp_path):
    from PIL import Image

    from mmrs_tpu_torch.io.images import load_image

    path = str(tmp_path / "wide.png")
    arr = np.zeros((40, 120, 3), np.uint8)
    arr[:, :40] = 255                            # the left third white
    Image.fromarray(arr).save(path)
    got = load_image(path, 30, "siglip")
    assert got.ok and got.pixels.shape == (30, 30, 3)
    assert got.pixels[:, :8].min() > 200 and got.pixels[:, 12:].max() < 60
    crop = load_image(path, 30, "openai").pixels   # the centre: all black
    assert crop.max() < 60
    with pytest.raises(ValueError, match="stack"):
        load_image(path, 30, "bogus")


def test_the_cli_indexes_and_searches_with_the_towers_geometry(tmp_path,
                                                              capsys):
    from PIL import Image

    from mmrs_tpu_torch.cli.main import main

    root = tmp_path / "imgs"
    for cls in ("a", "b"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            rng = np.random.default_rng(len(cls) * 10 + i + ord(cls))
            Image.fromarray(rng.integers(0, 256, (50, 80, 3), np.uint8)).save(
                root / cls / f"{i}.png")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("model:\n  image_tower: siglip_tiny\n"
                   "  text_tower: siglip_text_tiny\n")
    out = str(tmp_path / "idx")
    with pytest.raises(SystemExit) as e:
        main(["index", "build", "--root", str(root), "--out", out,
              "--config", str(cfg), "--workers", "2"])
    assert e.value.code == 0
    built = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert built["entries"] == 6 and built["dim"] == 144
    with pytest.raises(SystemExit) as e:
        main(["search", "--index", out, "--image",
              str(root / "a" / "1.png"), "-k", "2", "--config", str(cfg)])
    assert e.value.code == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 2 and rows[0].split("\t")[-1].endswith("a/1.png")
