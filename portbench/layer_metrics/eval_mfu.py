"""eval_mfu (%): the score tiles' FLOPs, 2 x Q x G x D for each of the
streaming evaluator's distance passes (extract and count), over the
traced seconds of an evaluation and the fp32 peak (the distances are fp32
with TF32 off). Source: device_trace (the traced window)."""

from harness.roofline import PEAK_FLOPS

SOURCE = "device_trace"


def read(obs):
    if not obs.get("evals") or not obs.get("window_s"):
        return None
    flops = (2.0 * obs["queries"] * obs["gallery_rows"] * obs["dim"]
             * obs["passes"])
    return 100.0 * flops / (obs["window_s"] / obs["evals"]) \
        / PEAK_FLOPS["fp32"]
