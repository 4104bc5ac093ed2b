"""One training step of mamba2-370m at full width (d 1024, 1 layer,
batch 1 x seq 512, AdamW) on the CPU, in the JAX package and in the
port, to show the reference's ``_ssd_chunked`` overflow where it
matters: at Q = 128 and full width ``dt·|A|`` sums past 88 inside a
chunk, the masked triangle's ``exp`` overflows, and the reference's
backward pass turns it into NaN.  The port masks the exponent before
the ``exp``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_ssm_overflow.py

Prints each side's loss, gradient norm and the parameter leaves left
non-finite by the update (the two sides draw their own weights).  About
a minute and 3 GB of host memory; not a test (the suite's files stay
small).
"""
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jax_get_config
from repro.data.synthetic import LMDataset as JLMDataset
from repro.launch.mesh import make_local_mesh
from repro.optim import make_optimizer as jax_make_optimizer
from repro.parallel.params import materialize as jax_materialize
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import LMDataset
from repro_torch.optim import AdamW
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import materialize, tree_leaves
from repro_torch.train.trainer import make_train_step


def reference():
    cfg = jax_get_config("mamba2-370m").replace(num_layers=1)
    opt = jax_make_optimizer("adamw", 1e-3)
    step, decls, _ = jax_make_train_step(cfg, make_local_mesh(1, 1), opt)
    params = jax_materialize(decls, 0)
    batch = JLMDataset(cfg.vocab_size, 1, 513, seed=0)(0)
    p, _, m = step(params, opt.init(params), jnp.int32(0), batch)
    bad = [jax.tree_util.keystr(k)
           for k, v in jax.tree_util.tree_flatten_with_path(p)[0]
           if not bool(jnp.all(jnp.isfinite(v)))]
    return float(m["loss"]), float(m["grad_norm"]), bad


def port():
    cfg = get_config("mamba2-370m").replace(num_layers=1)
    opt = AdamW(1e-3)
    step, decls, _ = make_train_step(cfg, MeshAxes(), opt, device="cpu")
    params = materialize(decls, torch.Generator().manual_seed(0), "cpu")
    batch = LMDataset(cfg.vocab_size, 1, 513, device="cpu")(0)
    p, _, m = step(params, opt.init(params), 0, batch)
    bad = [path for path, t in tree_leaves(p)
           if not bool(torch.isfinite(t).all())]
    return float(m["loss"]), float(m["grad_norm"]), bad


if __name__ == "__main__":
    for name, run in (("reference", reference), ("port", port)):
        loss, gnorm, bad = run()
        print(f"{name}: loss {loss:.6f} gradient norm {gnorm:.6g}; "
              f"{len(bad)} parameter leaves non-finite after the update"
              f"{': ' + ', '.join(bad) if bad else ''}", flush=True)
