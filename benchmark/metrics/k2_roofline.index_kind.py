"""K2 (ops/attention, csrc/mha_short_seq.cu) in an index_kind build's
traced slice: its launches of the tensor-core instance for heads padded
to 80 (`mha_mma_kernel<80, ...>`), each at its least time over a batch
[B, T, W] with the true head dim (bytes or operations,
benchmark/roofline_siglip.py), over their device time."""

from benchmark import derive, roofline_siglip


def instance_80(name: str) -> bool:
    return "mha_mma_kernel<80," in name or "mha_mma_kernelILi80E" in name


def read(run):
    if not getattr(run, "index_kind", False):
        return None
    least = roofline_siglip.k2_seconds(run.cfg["image_tower"],
                                       run.traffic["batch"])
    return derive.kernel_roofline(run, instance_80, least_of_launch=least)
