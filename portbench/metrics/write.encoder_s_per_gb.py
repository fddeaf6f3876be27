"""The device encoder (``DeviceBatchEncoder.encode_batch``): seconds of
the program's ``encode.*`` spans (transform, segment histograms, K6's
launch, the left-align and fetch; they do not nest) per raw GB
compressed."""


def read(run):
    if not run.spans:
        return None
    covered = sum(s for name, (_, s) in run.spans.items()
                  if name.startswith('encode.'))
    return covered / (run.bytes / 1e9) if covered > 0 else None
