"""The decode's audit and wait: seconds of the program's ``decode.fetch``
spans (the word-count audit, the call's one wait for the device) per
decoded GB."""


def read(run):
    if not run.spans or 'decode.fetch' not in run.spans:
        return None
    return run.spans['decode.fetch'][1] / (run.bytes / 1e9)
