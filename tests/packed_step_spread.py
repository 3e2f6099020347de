"""How far three packed AdamW steps drift between summation orders.

A measurement, not a test (pytest does not collect it). It runs the packed
three-step setting of ``test_torch_train.py::test_three_packed_train_steps_
match_jax`` (reduced qwen3-8b in f32, B = 2, S = 128, the packed varlen
source, lr 1e-2, warmup 2, 3 steps) three ways on the same weights and
batches: the JAX package on its Pallas kernels in interpret mode, the JAX
package on its dense reference (``impl="ref"``: the same function summed in
another order), and the port on its kernels' plain versions. For each pair
it counts the parameter elements that lie further apart than that file's
``PARAM_TOL`` (atol 1e-4, rtol 1e-4) and prints, for each such element,
its gradient at every step (from the JAX Pallas run), relative to the
largest gradient of its tensor, and how far the two JAX runs' gradients
differ there.

    PYTHONPATH=src python tests/packed_step_spread.py g2   # g1: G = 1, g2: two kv heads

jax 0.9 removed ``jax.core.trace_state_clean``, which the JAX package's
attention layers call; this script aliases it for its own process.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticVarlenLM as JaxSyntheticVarlenLM
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.training import optimizer as jax_opt
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM
from repro_torch.launch import steps
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.training import optimizer

B, S, STEPS = 2, 128, 3
OPT = dict(warmup_steps=2, total_steps=3, lr=1e-2)
ATOL = RTOL = 1e-4  # test_torch_train.py PARAM_TOL


def main(group: str) -> None:
    if not hasattr(jax.core, "trace_state_clean"):
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    jcfg = jax_registry.reduce_config(jax_registry.get("qwen3-8b"))
    cfg = registry.reduce_config(registry.get("qwen3-8b"))
    if group == "g2":
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    params0 = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))

    def to_port(tree):
        return params_from_jax(cfg, jax.tree.map(np.asarray, tree))

    def jax_run(attn):
        step = jax.jit(jax_steps.build_train_step(jcfg, attn, jax_opt.AdamWConfig(**OPT)))
        grad = jax.jit(jax.grad(lambda p, b: jax_steps.loss_fn(jcfg, attn, p, b)[0]))
        state, p, grads = jax_opt.init_opt_state(params0), params0, []
        data = JaxSyntheticVarlenLM(JaxDataConfig(batch_size=B, seq_len=S,
                                                  vocab_size=cfg.vocab_size, source="packed"))
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
            grads.append(to_port(grad(p, batch)))
            p, state, _ = step(p, state, batch)
        return to_port(p), grads

    pallas, g_pallas = jax_run(JaxAttentionConfig(impl="flash_pallas", interpret=True,
                                                  use_tuned=False))
    ref, g_ref = jax_run(JaxAttentionConfig(impl="ref"))
    model = LM(cfg, device="cpu")
    model.load_state_dict(to_port(params0))
    state = optimizer.init_opt_state(dict(model.named_parameters()))
    step = steps.build_train_step(cfg, AttentionConfig(impl="flash_cuda"),
                                  optimizer.AdamWConfig(**OPT))
    data = SyntheticVarlenLM(DataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size,
                                        source="packed"))
    for i in range(STEPS):
        state, _ = step(model, state, {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
    port = {n: p.detach() for n, p in model.named_parameters()}

    count = {"jax ref vs jax pallas": 0, "port vs jax pallas": 0, "port vs jax ref": 0}
    largest = dict.fromkeys(count, 0.0)
    for name in pallas:
        for pair, a, b in (("jax ref vs jax pallas", ref[name], pallas[name]),
                           ("port vs jax pallas", port[name], pallas[name]),
                           ("port vs jax ref", port[name], ref[name])):
            a, b = a.numpy().ravel(), b.numpy().ravel()
            diff = np.abs(a - b)
            idx = np.nonzero(diff > ATOL + RTOL * np.abs(b))[0]
            count[pair] += len(idx)
            largest[pair] = max(largest[pair], float(diff.max()))
            if not len(idx):
                continue
            at = [np.abs(g[name].numpy().ravel()[idx]).max() for g in g_pallas]
            rel = [x / float(g[name].abs().max()) for x, g in zip(at, g_pallas)]
            noise = [np.abs(r[name].numpy().ravel()[idx] - p[name].numpy().ravel()[idx]).max()
                     for r, p in zip(g_ref, g_pallas)]
            print(f"{pair}, {name}: {len(idx)} elements beyond PARAM_TOL, largest |diff| "
                  f"{diff[idx].max():.3e}; their |gradient| at steps 0-2 "
                  f"{', '.join(f'{x:.2e}' for x in at)} ("
                  f"{', '.join(f'{x:.1e}' for x in rel)} of the tensor's largest); the two JAX "
                  f"runs' gradients differ there by {', '.join(f'{x:.1e}' for x in noise)}")
    print(f"{group}: elements beyond PARAM_TOL: {count}")
    print(f"{group}: largest |diff| over all parameters: "
          + ", ".join(f"{k} {v:.3e}" for k, v in largest.items()))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "g2")
