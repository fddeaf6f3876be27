"""Set-up: from the start of the process to the first timed call (the
card's start, the recording made, written and encoded, one warm-up
call; the first run in a checkout also builds the program's kernels)."""


def read(run):
    return run.setup_s
