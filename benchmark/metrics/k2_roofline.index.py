"""K2 (the towers' attention kernel, ops/attention, csrc/mha_short_seq.cu)
in the traced slice: its least time at the batch's shape (bytes or
operations, benchmark/roofline.py) over its device time."""

from benchmark import derive, roofline


def read(run):
    if derive.generator(run) != "index":
        return None
    spec = run.cfg["image_tower"]
    tokens = (spec["image_size"] // spec["patch_size"]) ** 2 + 1
    least = roofline.k2_seconds(run.traffic["batch"], tokens, spec["width"])
    return derive.kernel_roofline(run, lambda n: "mha_" in n and "kernel" in n,
                                  least_of_launch=least)
