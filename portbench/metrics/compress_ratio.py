"""Storage cost: the recording's raw bytes over the ``.cbin`` plus
``.ch`` bytes the program wrote for it."""


def read(run):
    return run.ratio
