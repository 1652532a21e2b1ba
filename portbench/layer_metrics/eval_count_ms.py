"""eval_count_ms (ms): device time an evaluation spends in every kernel
but the GEMMs (the score tiles' matmuls), matched by name: the count
pass's compares, casts and sums, the extraction's gathers and the
metrics' algebra (``metrics/streaming_eval.py``). Source: device_trace."""

SOURCE = "device_trace"

GEMM = ("gemm", "xmma", "cutlass", "cublas")


def read(obs):
    t = obs.get("trace")
    if t is None or not obs.get("evals"):
        return None
    secs = sum(e["dur"] for e in t.device if e.get("cat") == "kernel"
               and not any(g in e.get("name", "").lower() for g in GEMM))
    return secs / 1e3 / obs["evals"] if secs else None
