"""Set-up seconds: from the process's start to the first timed step."""


def read(r):
    return r.setup_s
