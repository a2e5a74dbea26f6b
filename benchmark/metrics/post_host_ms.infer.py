"""Host time of the post-processing calls (decode, score threshold,
rotated NMS), each taken between two synchronisations in the profiled
requests, a frame."""


def read(rec):
    if not rec.post_s:
        return None
    return 1e3 * sum(rec.post_s) / (rec.requests * rec.batch)
