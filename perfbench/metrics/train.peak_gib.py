"""train.peak_gib (GiB): the allocator's peak over the measured window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)
in a training step. Moves pairs_per_s (it bounds the batch). Nothing to
read off the card."""


def read(run):
    if run.get("kind") != "train" or not run.get("memory_peak_bytes"):
        return None
    return run["memory_peak_bytes"] / 2 ** 30
