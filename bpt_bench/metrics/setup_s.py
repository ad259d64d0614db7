"""Set-up: process start to the first timed call, compilation included."""


def read(rec: dict):
    return rec.get("setup_s")
