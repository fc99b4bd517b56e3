"""K11 (a decode step's attention, ops/decode_attention.decode_attention,
csrc/decode_attention.cu decode_kernel) over the whole decodes in the
traced slice: each step's least time (the keys the causal mask allows,
each key/value head's read once; benchmark/roofline_vlm.py) over the
device time."""

from benchmark import derive_vlm, roofline, roofline_vlm


def read(run):
    if not derive_vlm.verifying(run):
        return None
    lm = run.cfg["language_model"]
    layers, b = lm["num_hidden_layers"], run.traffic["verify_batch"]
    steps = run.traffic["max_new_tokens"] - 1
    t = derive_vlm.prompt(run)

    def least(n):
        if n != steps * layers:
            return None
        return layers * sum(roofline.least_seconds(
            roofline_vlm.k11_flops(lm, b, t + s + 1),
            roofline_vlm.k11_bytes(lm, b, t + s + 1)) for s in range(steps))

    return derive_vlm.kernel_share(
        derive_vlm.attention_runs(run, derive_vlm.K11), least)
