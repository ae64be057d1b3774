"""Reverse-mode autodiff over the graph: arrives with slice A2 of the port.

Counterpart of ``hetu_tpu/graph/autodiff.py`` (``gradients``).  Until then
the call raises rather than returning something a caller could mistake for
gradients.
"""

from __future__ import annotations


def gradients(*args, **kwargs):
    raise NotImplementedError(
        "gradients arrive with slice A2 of the port (the BERT-base training "
        "step, ROADMAP.md)")
