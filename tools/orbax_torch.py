"""Convert a training checkpoint between the JAX package's orbax layout
and the PyTorch port's own (``kvedge_torch/runtime/checkpoint.py``).

    python tools/orbax_torch.py --config runtime.toml \\
        --from-orbax ORBAX_DIR --to-torch TORCH_DIR
    python tools/orbax_torch.py --config runtime.toml \\
        --from-torch TORCH_DIR --to-orbax ORBAX_DIR

Each directory is a checkpoint directory (what ``[runtime]
checkpoint_dir`` names; ``<state_dir>/checkpoints`` by default). The
latest step is converted and keeps its number. The runtime TOML is
parsed by both packages, and each side's restore template comes from
its own package's model derivation (the reference's
``train_model_config``, the port's ``RuntimeConfig.model_config``): a
checkpoint that does not match the configured model is refused with the
reference's ``_verify_template`` messages, never loaded.

The tree is ``{"params", "opt_state"}`` with the same param keys and
layer-stacked shapes in both packages. optax's ``adamw`` state is the
tuple ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``
(orbax renders it as dicts of string indices on disk); the port keeps
``{"count", "mu", "nu"}``. The conversion maps one to the other; the
empty states carry nothing.

The tool imports both packages, so it runs where JAX and orbax are
installed (the card's machine has neither); the port itself never
imports it.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _configs(text: str):
    """(the reference's model config, the port's), both at fp32."""
    import dataclasses

    from kvedge_torch.runtime.config import RuntimeConfig as TorchConfig
    from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
    from kvedge_tpu.runtime.workload import train_model_config

    jcfg, _ = train_model_config(JaxConfig.parse(text))
    tcfg = TorchConfig.parse(text).model_config("float32")
    return dataclasses.replace(jcfg, dtype="float32"), tcfg


def _jax_fresh_state(jcfg):
    """The reference trainer's state tree for ``jcfg`` (abstract)."""
    import jax

    from kvedge_tpu.models import init_params, make_train_step

    init_opt, _ = make_train_step(jcfg)

    def fresh():
        p = init_params(jax.random.PRNGKey(0), jcfg)
        return {"params": p, "opt_state": init_opt(p)}

    return jax.eval_shape(fresh), init_opt


def orbax_to_torch(text: str, src: str, dst: str) -> int:
    """Convert the latest orbax step under ``src`` into a port checkpoint
    under ``dst``; returns the step."""
    import numpy as np
    import torch

    from kvedge_torch.models.training import opt_state_template
    from kvedge_torch.models.weights import expected_shapes
    from kvedge_torch.runtime.checkpoint import StateCheckpointer as Ours
    from kvedge_torch.runtime.checkpoint import flatten, verify_template
    from kvedge_tpu.runtime.checkpoint import StateCheckpointer as Theirs

    jcfg, tcfg = _configs(text)
    abstract, _ = _jax_fresh_state(jcfg)
    with Theirs("", checkpoint_dir=src) as ckpt:
        restored = ckpt.restore_latest(abstract)
    if restored is None:
        raise SystemExit(f"no orbax checkpoint under {src}")
    step, tree = restored
    adam = tree["opt_state"][0]

    def tensors(d):
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in d.items()}

    out = {"params": tensors(tree["params"]),
           "opt_state": {"count": torch.tensor(int(adam.count),
                                               dtype=torch.int32),
                         "mu": tensors(adam.mu), "nu": tensors(adam.nu)}}
    template = {"params": expected_shapes(tcfg),
                "opt_state": opt_state_template(tcfg)}
    for key in ("params", "opt_state"):
        verify_template(flatten(template[key]), flatten(out[key]),
                        f"restore template ({key})")
    Ours("", checkpoint_dir=dst).save(step, out)
    return step


def torch_to_orbax(text: str, src: str, dst: str) -> int:
    """Convert the latest port step under ``src`` into an orbax
    checkpoint under ``dst``; returns the step."""
    import jax.numpy as jnp

    from kvedge_torch.models.training import opt_state_template
    from kvedge_torch.models.weights import expected_shapes
    from kvedge_torch.runtime.checkpoint import StateCheckpointer as Ours
    from kvedge_tpu.runtime.checkpoint import StateCheckpointer as Theirs
    from kvedge_tpu.runtime.checkpoint import _verify_template

    jcfg, tcfg = _configs(text)
    template = {"params": expected_shapes(tcfg),
                "opt_state": opt_state_template(tcfg)}
    restored = Ours("", checkpoint_dir=src).restore_latest(
        template)
    if restored is None:
        raise SystemExit(f"no port checkpoint under {src}")
    step, tree = restored

    def arrays(d):
        return {k: jnp.asarray(v.numpy()) for k, v in d.items()}

    params = arrays(tree["params"])
    abstract, init_opt = _jax_fresh_state(jcfg)
    opt_state = init_opt(params)
    adam = opt_state[0]._replace(
        count=jnp.asarray(int(tree["opt_state"]["count"]),
                          opt_state[0].count.dtype),
        mu=arrays(tree["opt_state"]["mu"]),
        nu=arrays(tree["opt_state"]["nu"]))
    out = {"params": params, "opt_state": (adam,) + tuple(opt_state[1:])}
    _verify_template(abstract, out, "restore template")
    with Theirs("", checkpoint_dir=dst) as ckpt:
        ckpt.save(step, out)
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True,
                    help="the runtime TOML (the model both sides derive)")
    pair = ap.add_mutually_exclusive_group(required=True)
    pair.add_argument("--from-orbax", metavar="DIR")
    pair.add_argument("--from-torch", metavar="DIR")
    ap.add_argument("--to-torch", metavar="DIR")
    ap.add_argument("--to-orbax", metavar="DIR")
    args = ap.parse_args(argv)
    with open(args.config, encoding="utf-8") as fh:
        text = fh.read()
    if args.from_orbax:
        if not args.to_torch:
            ap.error("--from-orbax needs --to-torch")
        step = orbax_to_torch(text, args.from_orbax, args.to_torch)
        print(f"[orbax-torch] step {step}: {args.from_orbax} -> "
              f"{args.to_torch}")
    else:
        if not args.to_orbax:
            ap.error("--from-torch needs --to-orbax")
        step = torch_to_orbax(text, args.from_torch, args.to_orbax)
        print(f"[orbax-torch] step {step}: {args.from_torch} -> "
              f"{args.to_orbax}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
