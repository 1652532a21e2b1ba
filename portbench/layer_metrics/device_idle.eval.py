"""device_idle.eval (%): 100 x (1 - device busy / traced wall), busy being
the union of the kernels', copies' and sets' intervals in the traced
window. Source: device_trace."""

SOURCE = "device_trace"


def read(obs):
    if not obs.get("window_s") or obs.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])
