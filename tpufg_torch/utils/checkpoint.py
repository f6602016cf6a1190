"""Reader of tpufg's parameter checkpoints, without JAX.

Counterpart of ``tpufg/utils/checkpoint.py::load_pytree`` for the learned
heads' ``{layer: {"b", "w"}}`` parameter dictionaries.  ``save_pytree``
writes one ``leaf_i`` array per pytree leaf, in the order JAX flattens a
dict (keys sorted), plus ``__treedef__``, the JSON-encoded ``str`` of the
tree definition, e.g.
``PyTreeDef({'c_body': {'b': *, 'w': *}, 'c_head': {'b': *, 'w': *}, ...})``.
So leaf ``2k`` is layer k's bias and leaf ``2k + 1`` its weight, with the
layers in sorted name order.
"""

from __future__ import annotations

import json
import re

import numpy as np

_LAYER = re.compile(r"'(\w+)': \{'b': \*, 'w': \*\}")


def load_layers(path: str) -> dict:
    """``{layer: {"w": array, "b": array}}`` as the file stores them (no
    shape checks: :func:`tpufg_torch.models.rife.load_params` holds them
    to an architecture).  Raises ValueError for a file that is not a
    ``{layer: {b, w}}`` tree written by ``save_pytree``."""
    with np.load(path) as data:
        if "__treedef__" not in data:
            raise ValueError(f"{path}: no __treedef__ (not a save_pytree "
                             "file)")
        treedef = json.loads(bytes(data["__treedef__"]).decode())
        names = _LAYER.findall(treedef)
        expect = ("PyTreeDef({" + ", ".join(
            f"'{n}': {{'b': *, 'w': *}}" for n in names) + "})")
        if not names or treedef != expect or names != sorted(names):
            raise ValueError(f"{path}: not a {{layer: {{b, w}}}} parameter "
                             f"tree: {treedef}")
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_leaves != 2 * len(names):
            raise ValueError(f"{path}: {n_leaves} leaves for {len(names)} "
                             "layers")
        return {n: {"b": data[f"leaf_{2 * i}"], "w": data[f"leaf_{2 * i + 1}"]}
                for i, n in enumerate(names)}
