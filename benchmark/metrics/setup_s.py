"""``setup_s``: process start to the window's start (the recording made
on the card, the kernel library built or loaded, one warm-up round with
the graph captures); host clock."""


def read(run):
    return run.setup_s
