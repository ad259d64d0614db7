"""Device dispatches a flush (the program's ``MicroBatcher.dispatches``)."""


def read(rec: dict):
    if not rec.get("flushes"):
        return None
    return rec["dispatches"] / rec["flushes"]
