"""codec_issue_ms.write: host milliseconds from the call of the codec's
encode_chunks_torch to its return, with no synchronise, the mean over the
window's requests."""

from yardstick.readers import ec


def read(run):
    return float(run.span_s("issue").mean()) * 1e3 \
        if ec(run, "encode") else None
