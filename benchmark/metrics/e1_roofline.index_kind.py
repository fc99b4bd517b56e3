"""E1 (ops/dense_epilogue, csrc/dense_epilogue.cu) in an index_kind
build's traced slice: its tanh-GELU launches (`bias_act_kernel<3, ...>`:
the MLPs' first layers), each at the mean least time of a batch's such
launches (bytes: f32 sums and bias in, bf16 out;
benchmark/roofline_siglip.py), over their device time."""

from benchmark import derive, roofline_siglip


def gelu_tanh_launch(name: str) -> bool:
    return "bias_act_kernel<3," in name or "bias_act_kernelILi3E" in name


def read(run):
    if not getattr(run, "index_kind", False):
        return None
    least = roofline_siglip.e1_gelu_seconds(run.cfg["image_tower"],
                                            run.traffic["batch"])
    return derive.kernel_roofline(run, gelu_tanh_launch,
                                  least_of_launch=least)
