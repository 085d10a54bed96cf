"""The trace reduction of tools/trace_stages.py: busy-time union, copy
classification and kernel families (the parts that do not need a GPU
trace)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import trace_stages  # noqa: E402


@pytest.mark.parametrize(
    "intervals,want",
    [
        ([], (0, 0)),
        ([(0, 10)], (10, 10)),
        ([(0, 10), (20, 25)], (15, 25)),
        ([(0, 10), (5, 15), (12, 14)], (15, 15)),  # overlapping + nested
        ([(30, 40), (0, 10)], (20, 40)),  # unsorted input
    ],
)
def test_busy_ns_is_interval_union(intervals, want):
    assert trace_stages.busy_ns(intervals) == want


@pytest.mark.parametrize(
    "name,kind",
    [("MemcpyH2D", "h2d"), ("MemcpyD2H", "d2h"), ("MemcpyD2D", "d2d"),
     ("memcpy32_post", None), ("sort_24_1", None)],
)
def test_copy_kind(name, kind):
    assert trace_stages._copy_kind(name) == kind


@pytest.mark.parametrize(
    "kernel,family",
    [("sort_24_1", "sort"), ("sort", "sort"), ("input_scatter_fusion_2", "input_scatter_fusion"),
     ("input_reduce_fusion.3", "input_reduce_fusion"), ("123", "123")],
)
def test_family_strips_numeric_suffixes(kernel, family):
    assert trace_stages._family(kernel) == family
