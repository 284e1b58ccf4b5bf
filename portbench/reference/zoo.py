"""Shape trees of the model zoo, as `meta` tensors in the port's layout
(conv OIHW, linear [out, in]), found by name: zoo `<kind>` is
portbench/zoos/<kind>.py, whose `shapes()` returns (the tree, the
HairFastConfig of its shapes), under the bench folder `where`. The
benchmark draws the weights into these shapes."""

from __future__ import annotations

from pathlib import Path

from portbench.registry import HERE, load_part


def zoo_shapes(kind: str, where: Path = HERE):
    """(shape tree in the port's layout, meta tensors; HairFastConfig)."""
    return load_part("zoos", kind, where).shapes()
