"""Peaks and the roofline bound."""

import pytest

import dry  # noqa: F401
from harness import roofline


def test_bound_takes_the_larger_of_bytes_and_operations():
    s, by = roofline.bound_s(3.35e12, 1.0, "bf16")
    assert (s, by) == (pytest.approx(1.0), "bytes")
    s, by = roofline.bound_s(1.0, 989e12, "bf16")
    assert (s, by) == (pytest.approx(1.0), "operations")
    assert roofline.bound_s(0, 495e12, "tf32")[0] == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12, "fp32")[0] == pytest.approx(1.0)
