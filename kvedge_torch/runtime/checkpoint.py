"""Checkpoints of the training state, in the port's own format.

The counterpart of the JAX package's ``runtime/checkpoint.py``, which
writes orbax trees. The card's machine has no orbax, so the port keeps
its own layout under the same directory rule (``<state_dir>/checkpoints``
unless ``[runtime] checkpoint_dir`` names another)::

    <checkpoint dir>/<step>/params.pt      fp32 params, flat key -> tensor
    <checkpoint dir>/<step>/opt_state.pt   AdamW moments and count

Each step is written into a temporary directory beside the others and
then ``os.replace``d to its name, so a reader never sees a half-written
step; the newest 3 are kept. Files load with
``torch.load(weights_only=True)``: tensors and plain containers only.
A restore template whose keys or shapes differ from what was saved is
refused with the reference's message, never loaded into a different
architecture.

A checkpoint is always the GLOBAL tree, as the reference's orbax
checkpoint is. Under a mesh (``parallel/mesh.py``) :meth:`save_global`
gathers the fp32 params and moments over rank 0's ``model``, ``expert``
and ``stage`` groups onto rank 0 alone, leaf by leaf, rank 0 writes them
as above, and every rank
then waits at a barrier;
:meth:`restore_global` reads the full tree on every rank and cuts the
rank's slices. So a checkpoint written by a world of N restores in a
world of M, and in the single-process ``serve`` payload, unchanged.
``tools/orbax_torch.py`` converts between this layout and the JAX
package's orbax checkpoints.
"""

from __future__ import annotations

import os
import shutil

import torch

CHECKPOINT_SUBDIR = "checkpoints"
_PARAMS = "params.pt"
_OPT = "opt_state.pt"


def resolve_checkpoint_dir(state_dir: str, checkpoint_dir: str = "") -> str:
    """``<state_dir>/checkpoints`` by default, else ``checkpoint_dir``;
    both made absolute. Remote URIs are not supported by the port."""
    if "://" in checkpoint_dir:
        raise ValueError(
            f"checkpoint_dir {checkpoint_dir!r}: the PyTorch port writes "
            "checkpoints to a local or mounted filesystem path only")
    return os.path.abspath(checkpoint_dir or os.path.join(state_dir,
                                                          CHECKPOINT_SUBDIR))


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{"mu": {"embedding": t}}`` -> ``{"mu/embedding": t}``."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten(value, name + "/"))
        else:
            flat[name] = value
    return flat


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *parents, leaf = name.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def verify_template(template: dict, saved: dict, source: str) -> None:
    """Raise unless ``saved`` has ``template``'s keys and shapes (both
    flat dicts of tensors or shape tuples)."""
    if set(template) != set(saved):
        raise ValueError(
            "checkpoint tree structure mismatch against the "
            f"{source}: the restore template has {sorted(template)}, the "
            f"checkpoint holds {sorted(saved)} — the configured model does "
            "not match the checkpointed one"
        )
    for key in sorted(template):
        want = tuple(getattr(template[key], "shape", template[key]))
        got = tuple(saved[key].shape)
        if want != got:
            raise ValueError(
                f"checkpoint shape mismatch against the {source} at "
                f"{key!r}: template expects {want}, checkpoint holds {got} "
                "— the configured model does not match the checkpointed one"
            )


class StateCheckpointer:
    """Synchronous saves and restores of ``{"params", "opt_state"}``
    trees under one checkpoint directory, keeping the newest ``keep``."""

    def __init__(self, state_dir: str, keep: int = 3,
                 checkpoint_dir: str = ""):
        self._dir = resolve_checkpoint_dir(state_dir, checkpoint_dir)
        self._keep = keep

    @property
    def directory(self) -> str:
        return self._dir

    def steps(self) -> list[int]:
        """Saved steps, oldest first."""
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isfile(os.path.join(self._dir, n, _PARAMS)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: dict) -> None:
        """Write ``tree`` (``params`` and optionally ``opt_state``) as step
        ``step``, atomically; then drop all but the newest ``keep``."""
        os.makedirs(self._dir, exist_ok=True)
        final = os.path.join(self._dir, str(step))
        tmp = os.path.join(self._dir, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, part in ((_PARAMS, tree["params"]),
                           (_OPT, tree.get("opt_state"))):
            if part is not None:
                torch.save({k: v.detach().cpu() for k, v in
                            flatten(part).items()}, os.path.join(tmp, name))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self._keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)),
                          ignore_errors=True)

    def restore(self, step: int, template: dict, *,
                device: torch.device | str = "cpu",
                params_only: bool = False) -> dict:
        """The tree saved at ``step``, checked against ``template`` (a
        ``{"params": ..., "opt_state": ...}`` tree of tensors or shape
        tuples; with ``params_only`` the optimizer state is neither
        read nor checked)."""
        tree = {}
        parts = (("params", _PARAMS),) if params_only else (
            ("params", _PARAMS), ("opt_state", _OPT))
        for key, name in parts:
            flat = torch.load(os.path.join(self._dir, str(step), name),
                              map_location=device, weights_only=True)
            verify_template(flatten(template[key]), flat,
                            f"restore template ({key})")
            tree[key] = unflatten(flat)
        return tree

    def save_global(self, step: int, tree: dict, mesh, cfg) -> None:
        """:meth:`save` of the global tree from every rank's slices (a
        collective: every rank calls it; module doc). Only the ranks
        whose ``data`` and ``seq`` coordinates are 0 gather, over the
        ``model``, ``expert`` and ``stage`` groups onto rank 0
        (``sharding.gather_params``); the rest wait at the barrier."""
        import torch.distributed as dist

        from kvedge_torch.parallel.sharding import gather_tree

        if not mesh.distributed:
            self.save(step, {k: gather_tree(mesh, v, cfg)
                             for k, v in tree.items()})
            return
        if all(mesh.index(axis) == 0 for axis in mesh.axis_names
               if axis not in ("model", "expert", "stage")):
            full = {k: gather_tree(mesh, v, cfg, dst=0)
                    for k, v in tree.items()}
            if dist.get_rank() == 0:
                self.save(step, full)
        dist.barrier()

    def restore_global(self, template: dict, mesh, cfg, **kw
                       ) -> tuple[int, dict] | None:
        """:meth:`restore_latest` of the global tree (``template`` is the
        full one), cut to this rank's slices."""
        from kvedge_torch.parallel.sharding import shard_tree

        restored = self.restore_latest(template, **kw)
        if restored is None:
            return None
        step, tree = restored
        return step, {k: shard_tree(mesh, v, cfg) for k, v in tree.items()}

    def restore_latest(self, template: dict, **kw) -> tuple[int, dict] | None:
        """(step, tree) of the newest checkpoint, or None when there is
        none."""
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, template, **kw)
