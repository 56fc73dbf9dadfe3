"""`torch.cuda.max_memory_allocated()` over the train window, GiB."""


def read(r):
    if r.loop != "train" or not r.peak_alloc_window:
        return None
    return r.peak_alloc_window / 2 ** 30
