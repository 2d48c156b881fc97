"""Loss trajectory of BERT pre-training in the JAX package and in the port,
on the CPU, from the same initial state.

The JAX package runs its startup program; its whole scope is carried into
the port with ``convert.load_numpy_state``; both then train ``--steps``
Adam steps on one repeated ragged batch and print one JSON line with both
loss lists. Run from the repo root:

    python tests/torch_loss_trajectory.py --d-model 768 --layers 2

Width, heads, vocab, seq and batch default to BERT-base's training shape
(d_inner is 4 x d_model); cut ``--layers`` to keep the CPU run short.
Dropout defaults to 0: the two packages draw their dropout seeds from
different generators, so only a run without dropout compares step by step.
"""

import argparse
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import paddle_tpu.fluid as jfluid  # noqa: E402
from paddle_tpu import unique_name as j_unique_name  # noqa: E402
from paddle_tpu.models import bert as j_bert  # noqa: E402

import paddle_tpu_torch.fluid as tfluid  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import unique_name as t_unique_name  # noqa: E402
from paddle_tpu_torch.models import bert as t_bert  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=11)
    a = ap.parse_args()
    cfg = dict(batch_size=a.batch, seq_len=a.seq, vocab_size=a.vocab,
               d_model=a.d_model, n_layers=a.layers, n_heads=a.heads,
               d_inner=4 * a.d_model, max_position=max(512, a.seq),
               dropout=a.dropout, is_train=True)
    with j_unique_name.guard():
        j_main, j_startup, j_handles = j_bert.get_model(**cfg)
    with t_unique_name.guard():
        t_main, _, t_handles = t_bert.get_model(**cfg)
    feed = j_bert.make_fake_batch(a.batch, a.seq, a.vocab,
                                  rng=np.random.RandomState(a.seed),
                                  varlen=True)

    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        j_losses = [float(np.asarray(exe.run(
            j_main, feed=feed, fetch_list=[j_handles["loss"]])[0]).reshape(()))
            for _ in range(a.steps)]

    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        t_losses = [float(t_exe.run(
            t_main, feed=feed, fetch_list=[t_handles["loss"]])[0].reshape(()))
            for _ in range(a.steps)]
    print(json.dumps({"config": cfg, "jax_losses": j_losses,
                      "port_losses": t_losses}))


if __name__ == "__main__":
    main()
