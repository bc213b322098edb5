"""grounding_ms.gen: a request's grounding layer in ms (the tokenizer for
the conditional and the null grounding, and a spatial model's
downsampler), from CUDA events around each call, the mean over the
window's requests."""


def read(record):
    reqs = record.get("grounding_ms") if record.get("kind") == "gen" else None
    return sum(reqs) / len(reqs) if reqs else None
