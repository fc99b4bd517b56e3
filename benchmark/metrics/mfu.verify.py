"""The operations of every answered image (the tower to its feature
layer, the projector, the prefill at the pack's own prompt length and the
decode steps; benchmark/roofline_vlm.py) over the window's seconds at
the bf16 peak."""

from benchmark import derive_vlm, roofline, roofline_vlm


def read(run):
    if not derive_vlm.verifying(run):
        return None
    b, new = run.traffic["verify_batch"], run.traffic["max_new_tokens"]
    flops = sum(b * roofline_vlm.answer_flops(run.cfg, t, new)
                for t in run.prompts)
    return 100.0 * flops / (run.elapsed * roofline.BF16_FLOPS)
