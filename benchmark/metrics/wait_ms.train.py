"""Mean ms a train step of the window waited for its batch (`train_one_epoch`'s `wait_ms`)."""


def read(r):
    waits = r.timing.get("wait_ms")
    if r.loop != "train" or not waits:
        return None
    return sum(waits) / len(waits)
