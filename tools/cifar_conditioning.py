"""How far the CIFAR models' gradients can be held to the JAX package's, on
the CPU (both packages; no card):

* ``--wrn``: WRN28-4 at published width, a batch of 2, over weight draws
  (kernels at JAX's init scale; group-norm scales and biases either JAX's
  ones and zeros or drawn around them): the fp64 gradient's largest move,
  as a share of each leaf's largest value, under two 1e-6 relative changes
  of the input, beside the port's fp32 gradient against ``jax.grad``.
  Where the first is large the input sits at a jump of the gradient (a
  ReLU input within rounding of 0, carried through 28 layers), and no
  fp32 implementation holds another to 1e-4 there.
* ``--gn``: torch's CPU ``group_norm`` backward in fp32 against fp64, on
  contiguous and channels-last activations whose groups' means sit at 0,
  3 and 30 standard deviations.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/cifar_conditioning.py --wrn --gn
"""
from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F


def wrn_survey(draws: int = 6) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs.paper_models import CIFAR10_WRN28 as JWRN28
    from repro.models import small as jsmall
    from repro_torch.configs.paper_models import CIFAR10_WRN28
    from repro_torch.data.synthetic import synthetic_cifar10
    from repro_torch.models import small
    from repro_torch.models.convert import small_params_from_jax

    jm, tm = jsmall.build_small_model(JWRN28), small.build_small_model(
        CIFAR10_WRN28)
    train, _ = synthetic_cifar10(n_train=16, n_test=16, seed=3)
    x, y = train.x[:2], train.y[:2]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    grad = jax.jit(jax.grad(jm.loss))

    def weights(seed: int, jax_norms: bool) -> dict:
        rng = np.random.default_rng(seed)

        def draw(path, leaf):
            name = jax.tree_util.keystr(path)
            if name.endswith("['s']"):
                v = np.ones(leaf.shape) if jax_norms else \
                    1.0 + 0.1 * rng.standard_normal(leaf.shape)
            elif name.endswith("['b']"):
                v = np.zeros(leaf.shape) if jax_norms else \
                    0.1 * rng.standard_normal(leaf.shape)
            else:
                v = rng.standard_normal(leaf.shape) / np.sqrt(
                    np.prod(leaf.shape[:-1]))
            return v.astype(np.float32)
        return jax.tree_util.tree_map_with_path(draw, shapes)

    def port_grads(tw, xx, dtype) -> dict:
        leaves = {k: v.to(dtype).requires_grad_() for k, v in tw.items()}
        loss = tm.loss(leaves, {"x": torch.tensor(xx).to(dtype),
                                "y": torch.tensor(y)})
        return dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))

    def share(a: dict, b: dict) -> float:
        return max(((a[k].double() - b[k].double()).abs().max()
                    / b[k].double().abs().max()).item() for k in b)

    for jax_norms in (True, False):
        for seed in range(draws):
            w = weights(seed, jax_norms)
            tw = small_params_from_jax(w, "cpu")
            g64 = port_grads(tw, x.astype(np.float64), torch.float64)
            moved = []
            for s in (1, 2):
                e = np.random.default_rng(s).standard_normal(x.shape)
                moved.append(share(port_grads(tw, x * (1 + 1e-6 * e),
                                              torch.float64), g64))
            jg = grad(jax.tree.map(jnp.asarray, w),
                      {"x": jnp.asarray(x), "y": jnp.asarray(y)})
            jflat = {}
            for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
                jflat[".".join(str(k.key) for k in path)] = torch.tensor(
                    np.asarray(leaf))
            vs_jax = share(port_grads(tw, x, torch.float32), jflat)
            print(f"WRN28 norms {'JAX init' if jax_norms else 'drawn'} "
                  f"seed {seed}: fp64 gradient moved by "
                  f"{moved[0]:.1e} / {moved[1]:.1e} under 1e-6 input "
                  f"changes; port fp32 vs jax.grad {vs_jax:.1e}",
                  flush=True)


def gn_survey() -> None:
    torch.manual_seed(0)
    for mean in (0.0, 3.0, 30.0):
        x64 = torch.randn(2, 128, 16, 16, dtype=torch.float64) + mean
        g64 = torch.randn(2, 128, 16, 16, dtype=torch.float64)
        out = {}
        for layout in ("contiguous", "channels_last"):
            res = []
            for dt in (torch.float32, torch.float64):
                x = x64.to(dt)
                if layout == "channels_last":
                    x = x.contiguous(memory_format=torch.channels_last)
                x.requires_grad_()
                gx, = torch.autograd.grad(F.group_norm(x, 8, eps=1e-5), x,
                                          g64.to(dt))
                res.append(gx.double())
            out[layout] = ((res[0] - res[1]).abs().max()
                           / res[1].abs().max()).item()
        print(f"group_norm backward, group mean {mean:g} std: fp32 vs fp64 "
              + ", ".join(f"{k} {v:.1e}" for k, v in out.items()))


if __name__ == "__main__":
    torch.set_num_threads(1)
    if "--gn" in sys.argv:
        gn_survey()
    if "--wrn" in sys.argv:
        wrn_survey()
