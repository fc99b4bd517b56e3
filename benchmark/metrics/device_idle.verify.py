"""Share of the traced slice of the verifier's window with no operation
on the device."""

from benchmark import derive, derive_vlm


def read(run):
    if not derive_vlm.verifying(run):
        return None
    return derive.idle_share(run)
