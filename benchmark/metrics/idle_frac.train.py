"""Share of the traced part of the window in which no kernel, memcpy or
memset ran on the card, in %."""


def read(rec):
    tr = rec.get("trace")
    if rec["driver"] != "train" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
