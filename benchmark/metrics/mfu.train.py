"""The training step's share of the chip's f32 peak: the FLOPs of its
matrix products at the geometry it runs (``roofline.train_commit_flops``
a commit: every commit padded to the configuration's full geometry,
training as 3x the forward) for the window's commits, over the window's
seconds and 67 TFLOP/s (one H100 SXM at 700 W; the run's
``device.power_limit`` beside it), in %."""


def read(rec):
    if rec["driver"] != "train":
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / rec["peak_flops"]
