"""Host ms a batch spends in ``SceneBatch.to`` (the upload of the padded
batch to the card), mean over the traced run's window."""


def read(o):
    ms = o.spans.get("upload")
    return sum(ms) / len(ms) if ms else None
