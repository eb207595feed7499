"""Fault tolerance for one tree's build: the level-synchronous builder's
whole state is (tree arrays, example assignment, level cursors), saved at
level boundaries through ``level_callback`` and restarted with
``build_tree(..., resume=restore_build_state(...))``.

Counterpart of ``repro.checkpoint.tree_ckpt``, with the same keys, shapes
and dtypes (``arrays/<field>`` of ``[max_nodes]``, without the port's drop
slot; ``assign``; the optional ``phist`` shard), so that a checkpoint of
either package resumes in the other.  The sibling-subtraction cache
(``BuildState.phist``) is saved when present, so the first resumed level
re-enters the subtraction path; it is derived state, and a checkpoint
without it resumes by recomputing that level's histograms in full.
"""
from __future__ import annotations

import json
import os

from repro_torch.checkpoint.checkpoint import (latest_step, restore_pytree,
                                               save_pytree)
from repro_torch.core.tree import TREE_FIELDS, BuildState

__all__ = ["TreeCheckpointer", "restore_build_state"]


class TreeCheckpointer:
    """Use as ``build_tree(..., level_callback=TreeCheckpointer(dir))``;
    saves every ``every_levels``-th level as step ``depth``."""

    def __init__(self, directory: str, every_levels: int = 1):
        self.directory = directory
        self.every = every_levels
        self._count = 0

    def __call__(self, state: BuildState):
        self._count += 1
        if self._count % self.every:
            return
        tree = {"arrays": state.arrays, "assign": state.assign}
        extra = {"level_start": int(state.level_start),
                 "level_end": int(state.level_end),
                 "next_free": int(state.next_free),
                 "depth": int(state.depth)}
        if state.phist is not None:
            tree["phist"] = state.phist
            extra["phist_base"] = int(state.phist_base)
        save_pytree(tree, self.directory, int(state.depth), extra=extra)


def restore_build_state(directory: str, template_arrays=None,
                        template_assign=None, step=None) -> BuildState:
    """The ``BuildState`` of step ``step`` (the latest by default), numpy
    arrays.  The templates are accepted for the reference's signature;
    only the keys of ``template_arrays`` are read (default: every tree
    field)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        has_phist = "phist" in json.load(f)["keys"]
    fields = TREE_FIELDS if template_arrays is None else tuple(template_arrays)
    template = {"arrays": dict.fromkeys(fields, 0), "assign": 0}
    if has_phist:
        template["phist"] = 0
    tree, manifest = restore_pytree(template, directory, step)
    ex = manifest["extra"]
    return BuildState(tree["arrays"], tree["assign"], ex["level_start"],
                      ex["level_end"], ex["next_free"], ex["depth"],
                      tree.get("phist"), ex.get("phist_base", -1))
