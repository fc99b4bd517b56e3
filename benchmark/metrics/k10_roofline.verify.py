"""K10 (the prefill chunks' attention, ops/decode_attention.chunk_attention,
csrc/decode_attention.cu chunk_kernel) over the whole prefills in the
traced slice: each chunk's least time (the keys the causal mask allows,
each key/value head's read once, or its operations;
benchmark/roofline_vlm.py) over the device time."""

from benchmark import derive_vlm, roofline, roofline_vlm


def read(run):
    if not derive_vlm.verifying(run):
        return None
    lm = run.cfg["language_model"]
    layers, b = lm["num_hidden_layers"], run.traffic["verify_batch"]
    chunk = run.cfg["verifier"]["prefill_chunk"]

    def least(n):
        t = [p for p in run.prompts if -(-p // chunk) * layers == n]
        if not t:
            return None
        t = int(sorted(t)[len(t) // 2])
        return layers * sum(roofline.least_seconds(
            roofline_vlm.k10_flops(lm, b, s, min(chunk, t - s)),
            roofline_vlm.k10_bytes(lm, b, s, min(chunk, t - s)))
            for s in range(0, t, chunk))

    return derive_vlm.kernel_share(
        derive_vlm.attention_runs(run, derive_vlm.K10), least)
