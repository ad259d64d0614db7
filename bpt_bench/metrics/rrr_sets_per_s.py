"""RRR sets of the refresh calls completed in the window, over the
window's whole time (to the end of its last call)."""


def read(rec: dict):
    if "sets" not in rec or rec["window_s"] <= 0:
        return None
    return rec["sets"] / rec["window_s"]
