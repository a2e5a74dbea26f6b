"""The whole request's share of the card's peak: the benchmark's own FLOP
count of a frame (``harness/flops.py`` over the plain reference at this
run's inputs) times the frames a second of the run's untraced window,
over the dense peak of the configuration's precision."""


def read(rec):
    if not getattr(rec, "flops_per_frame", 0) or not rec.frames_per_s:
        return None
    return 100.0 * rec.flops_per_frame * rec.frames_per_s / rec.peak_flops
