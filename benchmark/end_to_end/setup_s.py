"""From the start of the process to the window's: imports, the card coming
up, weights, the model, the graph capture (with any kernel build) and the
frames before the window."""


def read(rec: dict) -> float | None:
    return rec.get("setup_s")
