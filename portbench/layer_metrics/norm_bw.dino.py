"""norm_bw.dino (%): K8's share of its byte bound in the DINOv2 cell: the
bytes its launches moved (``harness/dinov2_flops.py::norm_bytes`` of the
program's counter ``vit.norms_fused``, the rows K8 launched on in the
device-only window) over the device time of the ``add_norm_kernel``
events in that window and the HBM rate, 3.35 TB/s
(``harness/roofline.py``). A program without the counter, or a trace
without K8's events (the CPU), reads None. Source: device_trace."""

from harness.dinov2_flops import norm_bytes
from harness.roofline import HBM_BYTES_PER_S

SOURCE = "device_trace"
KERNEL = "add_norm_kernel"


def read(obs):
    rows = obs.get("counts", {}).get("vit.norms_fused")
    trace, widths = obs.get("trace"), obs.get("widths")
    if not rows or trace is None or widths is None:
        return None
    us = sum(e["dur"] for e in trace.device
             if KERNEL in e.get("name", ""))
    if us <= 0:
        return None
    return 100.0 * norm_bytes(widths, rows) / (us / 1e6) / HBM_BYTES_PER_S
