"""The shared-sample estimator's reference (``estimator="shared"``, the
port's ``trace_shared``): the frozen pathtrace's own functions."""

from benchmark.reference.pathtrace import render_tile, train_loss

__all__ = ["render_tile", "train_loss"]
