"""E2 (the towers' LayerNorm, ops/layer_norm, csrc/layer_norm.cu) in an
index build's traced slice: its launches (`e2_layer_norm_kernel<...>`),
each at the mean least time of one batch's LayerNorm launches, over their
device time. A launch's least bytes: its bf16 rows read and written once,
the f32 gains and offsets read once (benchmark/roofline.py's peak).

A batch's norms follow the image tower's kind: CLIP's ViT (`vit`:
ln_pre, then two a block over every token, ln_post over the CLS rows
alone) and SigLIP's (`siglip_vit`: no ln_pre, two a block and ln_post
over every token, the MAP head's norm over its one row an image).

The bound is device memory's. At B/32 a launch moves 39 MB, which the
card's 50 MB L2 still holds from the launch before it, so there the share
reads the kernel against a bound it need not meet: 96.5% on an H100, and
it can pass 100% where a change keeps more of the rows in L2 (the residual
add folded into E2, say). At L/14 and SigLIP (270 MB and 860 MB a launch)
the bound holds."""

from benchmark import derive, roofline

F32 = 4
# kind -> (ln_pre over the tokens, ln_post over every token, the MAP
# head's norm); the blocks' two norms run in every kind
LAYOUT = {"vit": (True, False, False), "siglip_vit": (False, True, True)}


def e2_launch(name: str) -> bool:
    return "e2_layer_norm_kernel" in name


def launch_bytes(rows: int, width: int) -> float:
    return 2 * roofline.BF16 * rows * width + 2 * F32 * width


def batch_norms(spec, batch: int):
    """[(rows, width)] of one batch's LayerNorm launches, in order; None
    for a kind this reader does not know."""
    if spec["kind"] not in LAYOUT:
        return None
    pre, post_all, head = LAYOUT[spec["kind"]]
    w = spec["width"]
    tokens = (spec["image_size"] // spec["patch_size"]) ** 2
    tokens += 0 if post_all else 1          # CLIP's CLS token
    full = (batch * tokens, w)
    norms = [full] * (int(pre) + 2 * spec["layers"])
    norms.append(full if post_all else (batch, w))          # ln_post
    if head:
        norms.append((batch, w))
    return norms


def least_of_launch(spec, batch: int):
    norms = batch_norms(spec, batch)
    if not norms:
        return None
    total = sum(launch_bytes(r, w) for r, w in norms)
    return total / len(norms) / roofline.HBM_BYTES_PER_S


def read(run):
    if derive.generator(run) != "index":
        return None
    least = least_of_launch(run.cfg["image_tower"], run.traffic["batch"])
    if least is None:
        return None
    return derive.kernel_roofline(run, e2_launch, least_of_launch=least)
