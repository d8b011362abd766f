"""The port's ``ServeEngine`` against ``pt2tpu.serve.engine.ServeEngine`` on
every dense family case of tests/test_torch_families.py, f32 weights in the
"ssr" layout: five requests of 3-34 ids through two slots of max_len 64
(tiny-gemma3's window of 16 binds in admission and decode; tiny-bloom's
decode carries a per-row ALiBi bias; opt and gpt2 read learned positions
row by row), bf16 and int8 KV, quantum 1 and 4 -> identical tokens and the
same finish order.

int8 KV: the cache rounds each k/v value to an int8 step. Under jit, XLA's
fused f32 arithmetic can put a value that lies on a rounding edge on the
other side of it than the same program run op by op (``jax.disable_jit``)
does, and the stream then moves at a near-tie (met on tiny-gemma3 with
other prompts, the port agreeing with JAX's step run op by op). So an int8
stream that differs from JAX's jitted engine must equal JAX's engine run
op by op.

Each JAX engine runs once per module; torch runs on one intra-op thread."""

import jax
import numpy as np
import pytest
import torch

from pt2tpu.serve.engine import ServeEngine as JEngine
from pt2tpu_torch.serve.engine import ServeEngine
from test_torch_families import FAMILIES, configs, jax_params, to_port

LENS = (3, 25, 9, 34, 14)
MAX_NEW = (6, 9, 4, 10, 7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(engine, prompts):
    reqs = [engine.submit(p, m) for p, m in zip(prompts, MAX_NEW)]
    engine.run(max_steps=300)
    return [r.out for r in reqs], [r.uid for r in engine.finished]


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name):
    if name not in cases:
        jcfg, _ = configs(name)
        params = jax_params(name, "ssr", seed=11)
        rng = np.random.default_rng(len(name))
        prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in LENS]
        cases[name] = dict(params=params, tparams=to_port(params), prompts=prompts, jax={})
    return cases[name]


def _jax_run(c, name, kv_quant, quantum, eager=False):
    key = (kv_quant, quantum, eager)
    if key not in c["jax"]:
        jcfg, _ = configs(name)

        def go():
            return _run(JEngine(jcfg, c["params"], max_batch=2, max_len=64, kv_quant=kv_quant,
                                decode_quantum=quantum), c["prompts"])

        if eager:
            with jax.disable_jit():
                c["jax"][key] = go()
        else:
            c["jax"][key] = go()
    return c["jax"][key]


@pytest.mark.parametrize("quantum", [1, 4])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_tokens_and_finish_order_equal_jax(cases, name, kv_quant, quantum):
    c = _case(cases, name)
    _, tcfg = configs(name)
    eng = ServeEngine(tcfg, c["tparams"], max_batch=2, max_len=64, kv_quant=kv_quant,
                      decode_quantum=quantum)
    got = _run(eng, c["prompts"])
    want = _jax_run(c, name, kv_quant, quantum)
    if kv_quant and got != want:
        want = _jax_run(c, name, kv_quant, quantum, eager=True)
    assert got == want
    assert [len(o) for o in got[0]] == list(MAX_NEW)
    assert eng.stats["admitted"] == eng.stats["completed"] == len(LENS)


def test_learned_positions_bound_the_pool():
    """A pool longer than the model's learned positions raises."""
    _, tcfg = configs("tiny-gpt2")
    c = to_port(jax_params("tiny-gpt2", "ssr", seed=1))
    with pytest.raises(ValueError, match="learned positions"):
        ServeEngine(tcfg, c, max_batch=1, max_len=tcfg.max_seq_len + 1)
