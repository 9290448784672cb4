"""Logical-axis sharding: named dims -> mesh axes via a rule table.

Params and activations are annotated with *logical* dimension names
("batch", "heads", "vocab", ...); a rule table maps each name to mesh
axes ("data", "model", optionally "pod").  ``logical_spec`` resolves
names to a partition spec under the active ``axis_rules`` context,
applying two guards:

  * axes absent from the mesh are pruned (the same rules serve the
    single-pod (data, model) and multi-pod (pod, data, model) meshes);
  * a dim whose size does not divide the mapped axis-size product is
    replicated instead (e.g. hubert's vocab=504 on a 16-wide model
    axis), and a mesh axis is never assigned to two dims of one spec.

A spec is a tuple with one entry per dim: a mesh axis name, a tuple of
names, or None (replicated), the entries of the reference's
``PartitionSpec``.  A `NamedSharding` pairs it with its mesh
(``core.sharded.Mesh``, whose ``axis_names`` and ``shape`` are all the
rules read).  The launch tooling plans with these; the port's model
code runs on one card and carries no annotations, so `logical_shard`
only checks its names and never moves data.
"""
from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace
from typing import Any, Optional, Tuple

# logical dim -> mesh axis (str), axes (tuple), or None (replicate)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "zero": ("pod", "data"),      # ZeRO-sharded replicated dims
    "expert": ("pod", "data"),    # expert parallelism over the data axes
    "lists": ("pod", "data"),     # IVF list / block pools (RAIRS caches)
    "heads": "model",
    "kv": "model",
    "ff": "model",
    "vocab": "model",
    "ssm_head": "model",
    "d_model": None,
    "seq": None,
    "state": None,
    "blk": None,
    "kv_head_dim": None,          # serve caches override to "model"
}

_state = SimpleNamespace(ctx=None)   # (mesh, rules) or None

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's counterpart of ``NamedSharding``.
    Not a tuple, so the tree walkers treat it as one leaf."""
    mesh: Any
    spec: Spec

    def shards(self) -> int:
        """How many ways the spec splits a tensor: the product of the
        sizes of the mesh axes it uses."""
        n = 1
        for entry in self.spec:
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                n *= self.mesh.shape[a]
        return n


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[dict] = None):
    """Activate (mesh, rules) for logical_spec/logical_shard resolution."""
    prev = _state.ctx
    _state.ctx = (mesh, dict(DEFAULT_RULES if rules is None else rules))
    try:
        yield
    finally:
        _state.ctx = prev


def zero1_rules() -> dict:
    """Rules for ZeRO-1/3 shardings (the "zero" dim consumes data axes)."""
    return dict(DEFAULT_RULES)


def _mesh_axes(mesh, rule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in axes if a in tuple(mesh.axis_names))


def logical_spec(*names, shape: Tuple[int, ...]) -> Spec:
    """Resolve logical dim names to a spec under the active context.
    Requires ``axis_rules`` (or ``_state.ctx``) to be set."""
    assert _state.ctx is not None, "logical_spec needs an axis_rules context"
    mesh, rules = _state.ctx
    used = set()
    entries = []
    for i, name in enumerate(names):
        axes = _mesh_axes(mesh, rules.get(name)) if name else ()
        axes = tuple(a for a in axes if a not in used)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if not axes or size <= 1 or shape[i] % size != 0:
            entries.append(None)      # replicate: indivisible or unmapped
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    return tuple(entries)


def logical_shard(x, *names):
    """The in-graph annotation: the identity.  Under an ``axis_rules``
    context the spec is still resolved, so a bad name or rank raises as
    it would in the reference; the tensor is returned unmoved."""
    if _state.ctx is not None:
        logical_spec(*names, shape=tuple(x.shape))
    return x


def _map_specs(fn, tree, is_leaf):
    """fn over a tree of nested dicts whose leaves ``is_leaf`` names (a
    ``ParamSpec`` is a NamedTuple, which ``tree.tree_map`` would walk
    into)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], is_leaf) for k in sorted(tree)}
    return fn(tree)


def param_shardings(specs, mesh, rules: Optional[dict] = None, is_leaf=None,
                    logical_of=None):
    """Tree of NamedShardings for a ParamSpec tree (launch/train/serve)."""
    with axis_rules(mesh, rules=rules):
        def sh(s):
            names = tuple(logical_of(s)) if logical_of else tuple(s.logical)
            return NamedSharding(mesh, logical_spec(*names,
                                                    shape=tuple(s.shape)))
        return _map_specs(sh, specs, is_leaf)
