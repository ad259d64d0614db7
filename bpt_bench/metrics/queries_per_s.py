"""Queries answered over the window's whole time (to the last answer)."""


def read(rec: dict):
    if "answered" not in rec or rec["window_s"] <= 0:
        return None
    return rec["answered"] / rec["window_s"]
