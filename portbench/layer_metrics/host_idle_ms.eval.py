"""host_idle_ms.eval (ms): device-idle time an evaluation that lies inside
the spans ``eval.positives``, ``eval.place``, ``eval.metrics`` or the
self time of ``eval`` (``metrics/r1_map.py::R1mAP.compute`` less its
child spans): the host's own work that leaves the card idle, as against
the launch gaps inside ``eval.extract`` and ``eval.count``. Over the
device-only window's evaluations. Source: program_span, on the device
trace's idle intervals."""

from harness.spans import idle_ms_in

SOURCE = "program_span"
HOST = ("eval.positives", "eval.place", "eval.metrics")


def read(obs):
    return idle_ms_in(obs, HOST)
