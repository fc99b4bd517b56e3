"""An index_kind build's image tower: its operations for every image
indexed (counted from the shapes, benchmark/roofline_siglip.py) over the
build's seconds at the bf16 peak."""

from benchmark import roofline, roofline_siglip


def read(run):
    if not getattr(run, "index_kind", False) or run.elapsed <= 0:
        return None
    spec = run.cfg["image_tower"]
    flops = roofline_siglip.tower_flops_per_image(spec) * run.items
    return 100.0 * flops / (run.elapsed * roofline.BF16_FLOPS)
