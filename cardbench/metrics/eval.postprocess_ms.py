"""The host's time per batch in the window in `postprocess_batch` and
`MP3DEvaluator.process`, ms."""


def read(record):
    host, batches = record.get("host_ms", {}), record.get("batches")
    if "postprocess" not in host or not batches:
        return None
    return (host["postprocess"] + host.get("evaluator", 0.0)) / batches
