"""The image tower's operations for every image indexed (counted from the
shapes, benchmark/roofline.py) over the build's seconds at the bf16
peak."""

from benchmark import derive, roofline


def read(run):
    if derive.generator(run) != "index" or run.elapsed <= 0:
        return None
    flops = roofline.vit_flops_per_image(run.cfg["image_tower"]) * run.items
    return 100.0 * flops / (run.elapsed * roofline.BF16_FLOPS)
