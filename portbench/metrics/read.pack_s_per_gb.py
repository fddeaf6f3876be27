"""The decode's pack and upload: seconds of the program's
``decode.pack`` spans per decoded GB."""


def read(run):
    if not run.spans or 'decode.pack' not in run.spans:
        return None
    return run.spans['decode.pack'][1] / (run.bytes / 1e9)
