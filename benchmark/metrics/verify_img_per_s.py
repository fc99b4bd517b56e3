"""Images the verifier answered (collected and parsed) over the window's
seconds, the packs still in flight at its end included: image loads, K3,
the tower, the projector, the prefill, the decode steps and the parse."""

from benchmark import derive_vlm


def read(run):
    if not derive_vlm.verifying(run):
        return None
    return run.items / run.elapsed
