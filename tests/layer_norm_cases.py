"""The inputs and the distance that the LayerNorm tests (E2, ops/layer_norm)
share: tests/test_torch_layer_norm.py on the CPU, tests/test_torch_cuda.py
on the card. chip_smoke.py's E2 phase keeps a copy of `rows` and `ulps`
(it runs without the tests) that must stay as these are."""

import torch


def rows(m, w, seed, device="cpu"):
    """bf16 rows as the towers' residual streams: N(0, 1), every third row
    40 std from zero mean, every fifth of small spread."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, w), device=device, generator=g)
    x[::3] += 40.0
    x[1::5] *= 0.01
    return x.bfloat16()


def params(w, seed, device="cpu"):
    """f32 gains about 1, 1/64 of them 8x larger (outlier features, as
    benchmark/weights.draw makes them), and small f32 offsets."""
    g = torch.Generator(device=device).manual_seed(seed)
    gain = 1.0 + 0.05 * torch.randn(w, device=device, generator=g)
    gain[torch.rand(w, device=device, generator=g) < 1 / 64] *= 8.0
    return gain, 0.02 * torch.randn(w, device=device, generator=g)


def ulps(a, b, gain):
    """Largest |a - b| in bf16 spacings at max(|a|, |b|); an output within
    |gain| / 256 of zero is counted at the spacing there, where the f32
    rounding of the row's mean (carried through the gain) sets the
    difference rather than the output's one rounding."""
    a, b = a.float(), b.float()
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          gain.abs() * 2.0 ** -8)
    _, e = torch.frexp(scale)
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(scale),
                                               e - 8)).max())
