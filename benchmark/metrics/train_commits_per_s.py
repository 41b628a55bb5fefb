"""Commits in all the train steps completed in the window, over the
window's seconds (the window ends after a device synchronise)."""


def read(rec):
    if rec["driver"] != "train":
        return None
    return rec["commits"] / rec["window_s"]
