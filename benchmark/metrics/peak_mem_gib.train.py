"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated`` over the
window (the peak statistics reset at its start), in GiB."""


def read(record):
    if record.get("kind") != "train" or not record.get("memory_peak_bytes"):
        return None
    return record["memory_peak_bytes"] / 2**30
