"""Port parity of the survey's allreduce schedules (``repro_torch.core.
collectives``, §2.5) on ``torch.distributed`` against the JAX schedules
under ``shard_map`` on fake host devices (``conftest.run_multidev``).

The port runs as P processes, one rank each, on a ``gloo`` group over a
FileStore under the test's temporary directory (no TCP port, so the suite
can run several ways in parallel). Every launch has a time limit of its own
and every rank a collective timeout, so a dead rank fails the test instead
of hanging the suite. One launch per world size checks everything.

Tolerances: ring, tree, butterfly and rabenseifner take the reference
schedule's summation order, so each rank's result equals the JAX device's
bit for bit; ``psum`` (gloo's allreduce against XLA's) and the fallbacks
equal x.sum within rtol 1e-6.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from conftest import REPO, run_multidev
from repro.core import collectives as JCOLL
from repro_torch.core import collectives as coll

pytestmark = pytest.mark.port

SCHEDULES = ["ring", "tree", "butterfly", "rabenseifner"]

RANK_PRELUDE = """
import datetime, os
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.mesh import make_dp_group
RANK, P = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
OUT = os.environ["OUT"]
group = make_dp_group("cpu", init_method="file://" + os.environ["STORE"],
                      timeout=datetime.timedelta(seconds=90))
"""


def run_ranks(code, P, workdir, timeout=120):
    """Run `code` (after RANK_PRELUDE: RANK, P, OUT and the gloo `group`)
    in P processes, one rank each; every rank must exit 0 and print PASS
    within `timeout` seconds, else all are killed and the test fails.
    Returns the ranks' standard outputs."""
    script = workdir / "rank.py"
    script.write_text(RANK_PRELUDE + textwrap.dedent(code)
                      + "\ndist.destroy_process_group()\nprint('PASS')\n")
    store = workdir / f"store-{time.monotonic_ns()}"
    base = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
            "WORLD_SIZE": str(P), "OUT": str(workdir), "STORE": str(store),
            "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script)],
        env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(P)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0 and "PASS" in out, (
                f"rank {r} failed ({p.returncode}):\n{out}\n{err}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


JAX_CODE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.compat import shard_map
from repro.core import collectives as coll
x = jnp.asarray(np.load({x!r}))
mesh = jax.make_mesh((x.shape[0],), ('x',))
out = {{}}
for alg in coll.ALGORITHMS:
    f = shard_map(lambda v: coll.allreduce_sum(v[0], 'x', algorithm=alg)[None],
                  mesh=mesh, in_specs=P('x'), out_specs=P('x'),
                  check_vma=False)
    out[alg] = np.asarray(f(x))
np.savez({out!r}, **out)
print('PASS')
"""

PORT_CODE = """
from repro_torch.core import collectives as coll
from repro_torch.core.compression import make_compressor
x = torch.from_numpy(np.load(os.path.join(OUT, "x.npy"))[RANK])
out = {}
for alg in coll.ALGORITHMS:
    out[alg] = coll.allreduce_sum(x, group, alg).numpy()
    out[alg + "_rounds"] = coll.counts["rounds"]
    out[alg + "_mean"] = coll.allreduce_mean(x, group, alg).numpy()
    assert torch.equal(x, torch.from_numpy(
        np.load(os.path.join(OUT, "x.npy"))[RANK])), "input changed"
# one-rank groups return x; two-rank groups run over global ranks 2r, 2r+1
singles = [dist.new_group([r]) for r in range(P)]
for alg in coll.ALGORITHMS:
    assert coll.allreduce_sum(x, singles[RANK], alg) is x
    assert coll.counts["rounds"] == 0
if P == 4:
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    for alg in coll.ALGORITHMS:
        out["pair_" + alg] = coll.allreduce_sum(x, pairs[RANK // 2],
                                                alg).numpy()
# survey §6.3: int8-compressed ring allreduce with error feedback
g = torch.from_numpy(np.load(os.path.join(OUT, "g.npy"))[RANK])
gen = torch.Generator()
gen.manual_seed(1)
sent, res = make_compressor("int8").compress_with_feedback(
    {"g": g}, {"g": torch.zeros_like(g)}, gen)
out["sent_plus_residual"] = (sent["g"] + res["g"]).numpy()
out["compressed_sum"] = coll.allreduce_sum(sent["g"], group, "ring").numpy()
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{P: (x, g, JAX outputs, [rank outputs])} for P = 4 and 3."""
    res = {}
    for P in (4, 3):
        d = tmp_path_factory.mktemp(f"coll{P}")
        rng = np.random.default_rng(P)
        x = rng.standard_normal((P, 5, 37)).astype(np.float32)
        g = (rng.standard_normal((P, 1000)) * 0.01).astype(np.float32)
        np.save(d / "x.npy", x)
        np.save(d / "g.npy", g)
        run_multidev(JAX_CODE.format(x=str(d / "x.npy"),
                                     out=str(d / "jax.npz")),
                     devices=P, timeout=180)
        run_ranks(PORT_CODE, P, d)
        ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(P)]
        res[P] = (x, g, dict(np.load(d / "jax.npz")), ranks)
    return res


@pytest.mark.parametrize("alg", SCHEDULES)
def test_schedules_equal_the_jax_schedules_at_4_ranks(runs, alg):
    x, _, want, ranks = runs[4]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[alg], want[alg][r],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(got[alg], x.sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P", [4, 3])
def test_psum_equals_the_sum(runs, P):
    x, _, want, ranks = runs[P]
    for got, jax_out in zip(ranks, want["psum"]):
        np.testing.assert_allclose(got["psum"], x.sum(0), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["psum"], jax_out, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("alg", SCHEDULES)
def test_three_ranks_ring_or_fallback(runs, alg):
    """P = 3: the ring runs as at any P (equal to JAX's bit for bit); tree,
    butterfly and rabenseifner fall back to the backend's allreduce in one
    round, as the reference falls back to psum."""
    x, _, want, ranks = runs[3]
    for r, got in enumerate(ranks):
        if alg == "ring":
            np.testing.assert_array_equal(got[alg], want[alg][r])
        else:
            assert int(got[alg + "_rounds"]) == 1
            np.testing.assert_allclose(got[alg], x.sum(0), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("P", [4, 3])
def test_exchange_rounds_match_schedule_steps(runs, P):
    """The port's counterpart of test_ppermute_counts_in_hlo: the rounds a
    call runs are the survey's schedule steps — rank 0 takes part in every
    round of every schedule; the tree's other ranks in fewer."""
    ranks = runs[P][3]
    for alg in ("psum",) + tuple(SCHEDULES):
        want = coll.schedule_steps(alg, P) if (
            alg in ("psum", "ring") or P == 4) else 1
        got = [int(r[alg + "_rounds"]) for r in ranks]
        assert got[0] == max(got) == want, (alg, got, want)
        if alg != "tree":
            assert set(got) == {want}, (alg, got)


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8, 16])
def test_schedule_steps_equal_the_reference(P):
    for alg in coll.ALGORITHMS:
        assert coll.schedule_steps(alg, P) == JCOLL.schedule_steps(alg, P)
    assert coll.ALGORITHMS == JCOLL.ALGORITHMS


@pytest.mark.parametrize("P", [4, 3])
def test_mean_divides_the_sum_by_the_group_size(runs, P):
    for got in runs[P][3]:
        for alg in coll.ALGORITHMS:
            np.testing.assert_array_equal(got[alg + "_mean"],
                                          got[alg] / np.float32(P))


def test_two_rank_subgroups_reduce_within_their_pair(runs):
    x, _, _, ranks = runs[4]
    for r, got in enumerate(ranks):
        pair = x[2 * (r // 2)] + x[2 * (r // 2) + 1]
        for alg in coll.ALGORITHMS:
            np.testing.assert_allclose(got["pair_" + alg], pair, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{alg} rank {r}")


@pytest.mark.parametrize("P", [4, 3])
def test_int8_compressed_ring_allreduce_with_error_feedback(runs, P):
    """tests/test_collectives.py:65 at P ranks: the int8 round trip summed
    by the ring stays within 5% of the exact sum, and each rank's sent
    value plus its residual gives back its gradient."""
    _, g, _, ranks = runs[P]
    expect = g.sum(0)
    for r, got in enumerate(ranks):
        rel = (np.linalg.norm(got["compressed_sum"] - expect)
               / np.linalg.norm(expect))
        assert rel < 0.05, rel
        np.testing.assert_allclose(got["sent_plus_residual"], g[r],
                                   rtol=1e-6, atol=1e-9)
