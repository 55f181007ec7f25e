"""The port's process loader (cabinet_tpu_torch.data.grain_loader) against
the JAX package's GrainLoader: the JAX suite's contract
(tests/unit/test_grain_loader.py), the same len, shapes, dtypes and record
set per shard and epoch as grain gives, batches bit-equal to the port's
thread loader on a dataset tree (host recipe and canvas), and worker
failures raised in the caller.

Every test that starts worker processes runs in a subprocess under a
timeout, so that a hang fails the test rather than the suite; the datasets
the workers unpickle live in a module written to tmp_path."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

pytest.importorskip("grain")

from cabinet_tpu.data.grain_loader import GrainLoader as JGrainLoader  # noqa: E402
from cabinet_tpu.data.grain_loader import make_grain_loader as jmake_grain_loader  # noqa: E402
from cabinet_tpu_torch.data.grain_loader import GrainLoader, make_grain_loader  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 180


class ToyDataset:
    def __init__(self, n=10):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((4, 4, 3), float(i), np.float32),
                np.full((4, 4), i % 3, np.int64))


def _ids(batches):
    return [int(v) for imgs, *_ in batches for v in imgs[:, 0, 0, 0]]


# ---------------------------------------------------------------------------
# The JAX suite's contract, in the calling process
# ---------------------------------------------------------------------------


def test_batches_and_shapes():
    batches = list(make_grain_loader(ToyDataset(10), batch_size=4, num_epochs=1))
    assert len(batches) == 2  # drop_remainder
    imgs, lbls = batches[0]
    assert imgs.shape == (4, 4, 4, 3) and imgs.dtype == np.float32
    assert lbls.shape == (4, 4, 4) and lbls.dtype == np.int64


def test_shuffle_deterministic_by_seed():
    def order(seed):
        (imgs, _), = list(make_grain_loader(ToyDataset(12), batch_size=12, shuffle=True,
                                            num_epochs=1, seed=seed))
        return imgs[:, 0, 0, 0].astype(int).tolist()

    a, b, c = order(1), order(1), order(2)
    assert a == b
    assert a != c
    assert sorted(a) == list(range(12))


def test_covers_all_samples():
    seen = _ids(make_grain_loader(ToyDataset(8), batch_size=2, num_epochs=1))
    assert sorted(seen) == list(range(8))


def test_grain_loader_epoch_interface():
    dl = GrainLoader(ToyDataset(10), batch_size=4, shuffle=True, drop_last=True,
                     num_workers=0, seed=3)
    assert len(dl) == 2
    dl.set_epoch(0)
    e0a, e0b = _ids(dl), _ids(dl)
    assert e0a == e0b  # re-iterable, deterministic within an epoch
    dl.set_epoch(1)
    e1 = _ids(dl)
    assert e0a != e1  # reshuffled across epochs
    assert len(e0a) == len(e1) == 8


def test_grain_loader_no_drop_last():
    dl = GrainLoader(ToyDataset(10), batch_size=4, num_workers=0)
    assert len(dl) == 3
    assert [imgs.shape[0] for imgs, _ in dl] == [4, 4, 2]


def test_explicit_shard_tuple_is_honored():
    seen = {}
    for idx in (0, 1):
        ids = _ids(make_grain_loader(ToyDataset(8), batch_size=2, num_epochs=1,
                                     shard=(idx, 2)))
        assert len(ids) == 4, ids  # equalized: 8 // 2 records per shard
        seen[idx] = set(ids)
    assert seen[0] & seen[1] == set()
    assert seen[0] | seen[1] == set(range(8))


def test_make_grain_loader_epochs_reshuffle_and_end():
    """num_epochs=k yields k epochs, epoch e in the order of (seed, e)."""
    batches = list(make_grain_loader(ToyDataset(12), 12, shuffle=True, num_epochs=3, seed=4))
    assert len(batches) == 3
    orders = [b[0][:, 0, 0, 0].astype(int).tolist() for b in batches]
    for e, order in enumerate(orders):
        assert order == np.random.default_rng([4, e]).permutation(12).tolist()
    endless = make_grain_loader(ToyDataset(4), 2, num_epochs=None)
    assert len([next(endless) for _ in range(7)]) == 7
    endless.close()


# ---------------------------------------------------------------------------
# Against the JAX package's GrainLoader (grain)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,batch,shard,drop_last", [
    (10, 4, None, False), (10, 4, None, True), (10, 2, (0, 3), False),
    (10, 2, (1, 3), True), (10, 4, (2, 3), False), (11, 3, (1, 2), True),
    (8, 3, (1, 4), False)])
def test_len_shapes_and_records_per_shard_match_jax(n, batch, shard, drop_last):
    """The same len(), batch shapes and dtypes, and per epoch the same set of
    records as grain's: shard i owns records [i*(n//c), (i+1)*(n//c)), every
    epoch. The order within an epoch is the port's (seed, epoch)
    permutation, not grain's index shuffle."""
    kw = dict(shuffle=True, drop_last=drop_last, num_workers=0, seed=7, shard=shard)
    port, ref = GrainLoader(ToyDataset(n), batch, **kw), JGrainLoader(ToyDataset(n), batch, **kw)
    assert len(port) == len(ref)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert [(a.shape, a.dtype) for a in g] == [(a.shape, a.dtype) for a in w]
        size = n if shard is None else n // shard[1]
        first = 0 if shard is None else shard[0] * size
        owned = list(range(first, first + size))
        assert sorted(set(_ids(want))) == sorted(_ids(want))
        if drop_last and size % batch:
            # the trailing partial batch goes, whose records follow the order
            assert len(_ids(got)) == len(_ids(want))
            assert set(_ids(got)) <= set(owned) and set(_ids(want)) <= set(owned)
        else:
            assert sorted(_ids(got)) == sorted(_ids(want)) == owned
        perm = np.asarray(owned)[np.random.default_rng([7, epoch]).permutation(size)]
        assert _ids(got) == perm[:len(_ids(got))].tolist()


def test_unshuffled_shards_match_jax_order():
    """Without shuffle the records come in grain's order too."""
    for shard in (None, (0, 3), (2, 3)):
        got = _ids(make_grain_loader(ToyDataset(10), 2, num_epochs=1, shard=shard,
                                     drop_remainder=False))
        want = _ids(jmake_grain_loader(ToyDataset(10), 2, num_epochs=1, shard=shard,
                                       drop_remainder=False))
        assert got == want


def test_canvas_triples_collate_like_jax():
    """Three-field records (the device canvas) stack field by field."""
    class Canvas:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return (np.full((6, 6, 3), i, np.uint8), np.full((6, 6), 255, np.uint8),
                    np.array([4, 5], np.int32))

    port = list(GrainLoader(Canvas(), 2, num_workers=0))
    ref = list(JGrainLoader(Canvas(), 2, num_workers=0))
    assert len(port) == len(ref) == 3
    for g, w in zip(port, ref):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_make_loader_builds_the_process_loader():
    from cabinet_tpu.cli import common as jcommon
    from cabinet_tpu.core.config import compose as jcompose
    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.core.config import compose

    args = ["checkpoint_path=x", "runtime.loader=grain"]
    cfg, jcfg = compose(common.CONFIG_DIR, "evaluate", args), jcompose(
        jcommon.CONFIG_DIR, "evaluate", args)
    kw = dict(shuffle=True, drop_last=False, num_workers=0, seed=2, shard=(1, 3))
    port = common.make_loader(cfg, ToyDataset(10), 2, **kw)
    ref = jcommon.make_loader(jcfg, ToyDataset(10), 2, **kw)
    assert isinstance(port, GrainLoader) and len(port) == len(ref) == 2
    assert sorted(_ids(port)) == sorted(_ids(ref)) == [3, 4, 5]
    thread = ["checkpoint_path=x"]  # the thread loader's shard is the JAX loader's
    port = common.make_loader(compose(common.CONFIG_DIR, "evaluate", thread), ToyDataset(10),
                              2, **kw)
    ref = jcommon.make_loader(jcompose(jcommon.CONFIG_DIR, "evaluate", thread),
                              ToyDataset(10), 2, **kw)
    assert not isinstance(port, GrainLoader) and len(port) == len(ref) == 2
    assert _ids(port) == _ids(ref)
    with pytest.raises(ValueError, match="shard"):
        GrainLoader(ToyDataset(4), 2, shard=(2, 2))


# ---------------------------------------------------------------------------
# Worker processes, each case in a subprocess under a timeout
# ---------------------------------------------------------------------------

_TOY_MODULE = textwrap.dedent("""
    import os
    import numpy as np

    class Toy:
        def __init__(self, n):
            self.n, self.epoch = n, 0

        def set_epoch(self, epoch):
            self.epoch = epoch

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return (np.full((4, 4, 3), float(i) + 100 * self.epoch, np.float32),
                    np.full((4, 4), os.getpid(), np.int64))

    class Raising(Toy):
        def __getitem__(self, i):
            if i == 5:
                raise OSError(f"unreadable record {i}")
            return super().__getitem__(i)

    class Dying(Toy):
        def __getitem__(self, i):
            if i == 5:
                os._exit(3)
            return super().__getitem__(i)
""")


def _run(tmp_path, body, *args, stderr=False):
    """Run `body` in a fresh interpreter whose sys.path holds the repo and
    tmp_path's `toyds` module; returns its last stdout line as JSON (and its
    stderr, if asked)."""
    (tmp_path / "toyds.py").write_text(_TOY_MODULE)
    code = (f"import sys\nsys.path[:0] = [{str(REPO)!r}, {str(tmp_path)!r}]\n"
            + textwrap.dedent(body))
    res = subprocess.run([sys.executable, "-c", code, *map(str, args)], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    return (out, res.stderr) if stderr else out


def test_worker_processes_keep_the_contract(tmp_path):
    """Two workers (forked by the forkserver): every record once, the same batches as in the
    calling process, the epoch reaching the workers' own copies through the
    records (not the parent's set_epoch), the workers kept across epochs and
    passes, and none left after close() or after the loader is collected."""
    out = _run(tmp_path, """
        import gc, json, multiprocessing as mp
        from cabinet_tpu_torch.data.grain_loader import GrainLoader
        from toyds import Toy

        def passes(dl):
            ids, pids = [], set()
            for epoch in (0, 1, 1):
                dl.set_epoch(epoch)
                batches = list(dl)
                ids.append([int(v) for b in batches for v in b[0][:, 0, 0, 0]])
                pids |= {int(p) for b in batches for p in b[1][:, 0, 0]}
            return ids, sorted(pids)

        inline, _ = passes(GrainLoader(Toy(10), 4, shuffle=True, num_workers=0, seed=3))
        procs = GrainLoader(Toy(10), 4, shuffle=True, num_workers=2, seed=3)
        ids, pids = passes(procs)
        children = len(mp.active_children())
        procs.close()
        after_close = len(mp.active_children())
        again = GrainLoader(Toy(8), 4, num_workers=2)
        seen = sorted(int(v) for imgs, _ in again for v in imgs[:, 0, 0, 0])
        del again
        gc.collect()
        print(json.dumps({"inline": inline, "ids": ids, "pids": pids,
                          "children": children, "after_close": after_close,
                          "seen": seen, "after_del": len(mp.active_children())}))
    """)
    assert out["ids"] == out["inline"]
    assert sorted(out["ids"][0]) == list(range(10))
    assert out["ids"][1] == out["ids"][2]
    assert sorted(out["ids"][1]) == [100 + i for i in range(10)]
    assert len(out["pids"]) == 2 and out["children"] == 2
    assert out["after_close"] == 0 and out["after_del"] == 0
    assert out["seen"] == list(range(8))


@pytest.mark.parametrize("close", [True, False])
def test_no_process_outlives_the_caller(tmp_path, close):
    """The forkserver that forks the workers, and the resource tracker
    beside it, are stopped and reaped by stop_servers() (a later loader
    starts them again) and by the calling process's exit, whether or not it
    closed its last loader: once the caller has exited, neither exists."""
    out, err = _run(tmp_path, f"""
        import json, os
        import multiprocessing.forkserver as fs
        import multiprocessing.resource_tracker as rt
        from cabinet_tpu_torch.data.grain_loader import GrainLoader, stop_servers
        from toyds import Toy

        def servers():
            return [fs._forkserver._forkserver_pid, rt._resource_tracker._pid]

        first = GrainLoader(Toy(6), 2, num_workers=2)
        n_first = len(list(first))
        first.close()
        started = servers()
        stop_servers()
        gone = [not os.path.exists(f"/proc/{{pid}}") for pid in started]
        last = GrainLoader(Toy(6), 2, num_workers=2)
        n_last = len(list(last))
        if {close}:
            last.close()
        print(json.dumps({{"batches": [n_first, n_last], "started": started,
                          "gone": gone, "restarted": servers()}}))
    """, stderr=True)
    assert out["batches"] == [3, 3]
    assert all(out["started"]) and out["gone"] == [True, True]
    assert all(out["restarted"]) and out["restarted"][0] != out["started"][0]
    left = [pid for pid in out["restarted"] if Path(f"/proc/{pid}").exists()]
    assert not left, f"processes left after the caller exited: {left}"
    assert "Traceback" not in err, err


@pytest.mark.parametrize("kind,error,message", [
    ("Raising", "OSError", "unreadable record 5"),
    ("Dying", "RuntimeError", "exited unexpectedly")])
def test_a_failing_worker_raises_in_the_caller(tmp_path, kind, error, message):
    """A worker that raises, or one that dies, ends the pass with an error in
    the calling process: no hang, no partial epoch passed off as whole."""
    out = _run(tmp_path, f"""
        import json, multiprocessing as mp
        from cabinet_tpu_torch.data.grain_loader import GrainLoader
        from toyds import {kind}

        dl = GrainLoader({kind}(10), 2, num_workers=2)
        got = 0
        try:
            for _ in dl:
                got += 1
            err = None
        except Exception as e:
            err = f"{{type(e).__name__}}: {{e}}"
        dl.close()
        print(json.dumps({{"err": err, "batches": got,
                          "left": len(mp.active_children())}}))
    """)
    assert out["err"] is not None, out
    assert out["err"].startswith(error + ":") and message in out["err"], out
    assert out["batches"] < 5 and out["left"] == 0


_TREE_RUN = """
    import json, sys
    from pathlib import Path
    import numpy as np
    from cabinet_tpu_torch.data.datasets import UAVid
    from cabinet_tpu_torch.data.grain_loader import GrainLoader
    from cabinet_tpu_torch.data.loader import DataLoader

    root, canvas = Path(sys.argv[1]), sys.argv[2] == "canvas"
    kw = dict(photometric="device", geometric="device") if canvas else {}
    digests = {}
    for name, cls in (("thread", DataLoader), ("grain", GrainLoader)):
        ds = UAVid(255, str(root), [32, 32], mode="train", seed=9, **kw)
        dl = cls(ds, 2, shuffle=True, drop_last=True, num_workers=2, seed=5)
        out = []
        for epoch in (0, 1):
            dl.set_epoch(epoch)
            out.append([[f.dtype.str + str(f.shape) + f.tobytes().hex() for f in b]
                        for b in dl])
        dl.close()
        digests[name] = out
    print(json.dumps({"equal": digests["thread"] == digests["grain"],
                      "batches": [len(e) for e in digests["grain"]],
                      "fields": len(digests["grain"][0][0]),
                      "epochs_differ": digests["grain"][0] != digests["grain"][1]}))
"""


def _uavid_tree(root, n=6, size=(40, 48), seed=0):
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "masks" / split).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
                root / "images" / split / f"s{i}.png")
            Image.fromarray(rng.integers(0, 8, size, dtype=np.uint8), "L").save(
                root / "masks" / split / f"s{i}.png")
    return root


@pytest.mark.parametrize("pipeline", ["host", "canvas"])
def test_process_and_thread_batches_are_bit_identical(tmp_path, pipeline):
    """On a UAVid tree in train mode (the host recipe with mixup, or the u8
    canvas triple), the process loader and the thread loader give the same
    batches bit for bit in epochs 0 and 1: each sample is a function of
    (seed, epoch, idx), and the epoch reaches the workers with the records."""
    root = _uavid_tree(tmp_path / "uavid")
    out = _run(tmp_path, _TREE_RUN, root, pipeline)
    assert out["equal"] and out["epochs_differ"]
    assert out["batches"] == [3, 3]
    assert out["fields"] == (3 if pipeline == "canvas" else 2)
