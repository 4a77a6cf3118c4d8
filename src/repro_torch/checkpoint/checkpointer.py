"""Fault-tolerant checkpointing with writer-lease handover — the twin of
the JAX package's `checkpoint/checkpointer.py`, over trees of tensors
(nested dicts, NamedTuples such as `launch.steps.TrainState`, tuples).

The on-disk format is the reference's, byte for byte: the same layout and
files, the same array keys (a NamedTuple field is written ``.name``, as
`jax.tree_util.tree_flatten_with_path` names it: ``.params/embed``,
``.opt/m/layers/attn/wq``, ``.step``), the same dtype strings and crc32s.
A checkpoint written by either package restores in the other. bf16
arrays are written and read as their raw 2-byte words under the dtype
string ``"bfloat16"``, without `ml_dtypes`.

Layout per checkpoint (mirrors TF's data/index/meta triple — the sizes feed
the §IV prediction models):
    step_<N>/
      data-00000.bin     array payload, concatenated           (S_d)
      index.json         leaf -> (offset, shape, dtype, crc32)  (S_i)
      meta.json          pytree structure + user metadata       (S_m)
    LATEST               atomic pointer to the newest committed step
    writer.lease         checkpoint-writer lease (chief handover, §V-E)

Properties the paper's transient setting needs:
  * atomic commit (tmp dir + rename): a revocation mid-write never corrupts
    the latest checkpoint;
  * the writer role is a LEASE, not an identity: any surviving worker can
    steal an expired lease and continue checkpointing (CM-DARE's fix for the
    chief-IP recomputation pathology, Fig 11).

The reference's background-thread write mode (``async_write``) is not
ported: the trainer saves synchronously, as the paper measures.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed integrity validation (missing file,
    short payload, or per-array checksum mismatch)."""


class LeaseLostError(RuntimeError):
    """The writer lease was lost between starting a save and committing
    it; the commit was aborted so no torn/contested state was published."""


@dataclasses.dataclass
class CheckpointSizes:
    s_d: int
    s_i: int
    s_m: int

    @property
    def total(self) -> int:
        return self.s_d + self.s_i + self.s_m


class WriterLease:
    """File-based lease: holder writes {holder, expires}; others may steal
    after expiry or an explicit revocation notification.

    `clock` is injectable (default `time.time`) so chaos `VirtualClock`
    scenarios exercise expiry and steal races deterministically instead
    of sleeping. Acquisition is verified by reading back the committed
    lease file: under a steal race both contenders pass the pre-check,
    but only the one whose rename landed last actually holds the lease.
    """

    def __init__(self, root: str, holder: str, ttl_s: float = 60.0,
                 clock: Callable[[], float] = time.time):
        self.path = os.path.join(root, "writer.lease")
        self.holder = holder
        self.ttl = ttl_s
        self.clock = clock

    def _read(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def try_acquire(self, now: Optional[float] = None) -> bool:
        now = self.clock() if now is None else now
        cur = self._read()
        if cur is not None and cur["holder"] != self.holder \
                and cur["expires"] > now and not cur.get("revoked"):
            return False
        # per-holder tmp name: two stealers racing must not truncate each
        # other's in-flight write before the atomic rename
        tmp = f"{self.path}.tmp.{self.holder}"
        with open(tmp, "w") as f:
            json.dump({"holder": self.holder, "expires": now + self.ttl,
                       "revoked": False}, f)
        os.replace(tmp, self.path)
        cur = self._read()
        return cur is not None and cur.get("holder") == self.holder

    def held_by_me(self, now: Optional[float] = None) -> bool:
        cur = self._read()
        now = self.clock() if now is None else now
        return (cur is not None and cur["holder"] == self.holder
                and cur["expires"] > now and not cur.get("revoked"))

    def notify_revoked(self) -> None:
        """Revocation notification (transient-TF's hook): immediately frees
        the lease so a survivor can take over without waiting for expiry."""
        cur = self._read() or {"holder": self.holder, "expires": 0}
        cur["revoked"] = True
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cur, f)
        os.replace(tmp, self.path)


def _leaf_paths(tree, prefix: Tuple[str, ...] = ()):
    """(path tuple, leaf) pairs in the reference's flatten order: dict keys
    sorted, NamedTuple fields as ``.name`` in field order, other tuples and
    lists by index."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaf_paths(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _rebuild(tree, fn, prefix: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), fn, prefix + (f".{n}",))
                            for n in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(array, dtype string) as the reference writes them; a bf16 array is
    its raw 2-byte words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {"/".join(path): _host(leaf) for path, leaf in _leaf_paths(tree)}


def _from_record(blob: bytes, rec: dict) -> torch.Tensor:
    bf16 = rec["dtype"] == "bfloat16"
    arr = np.frombuffer(
        blob, dtype=np.int16 if bf16 else np.dtype(rec["dtype"]),
        count=int(np.prod(rec["shape"])) if rec["shape"] else 1,
        offset=rec["offset"]).reshape(rec["shape"])
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if bf16 else t


class Checkpointer:
    def __init__(self, root: str, holder: str = "worker-0",
                 keep: int = 3,
                 clock: Callable[[], float] = time.time):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.lease = WriterLease(root, holder, clock=clock)
        self.keep = keep
        #: seconds the last save took (`Session.checkpoint_seconds`' T_c)
        self.last_save_seconds: Optional[float] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, metadata: Optional[dict] = None
             ) -> Optional[CheckpointSizes]:
        """Write ``tree`` as ``step_<step>`` if this holder has (or can
        take) the writer lease, else return None. The commit is fenced: a
        lease lost during the write raises `LeaseLostError` before the
        rename."""
        if not self.lease.held_by_me():
            if not self.lease.try_acquire():
                return None  # someone else holds the writer role
        t0 = time.monotonic()
        sizes = self._write(step, _flatten(tree), metadata or {})
        self.last_save_seconds = time.monotonic() - t0
        return sizes

    def _write(self, step: int, flat: Dict[str, Tuple[np.ndarray, str]],
               metadata: dict) -> CheckpointSizes:
        tmp = os.path.join(self.root, f".tmp_step_{step}")
        final = os.path.join(self.root, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        index: Dict[str, Any] = {}
        offset = 0
        data_path = os.path.join(tmp, "data-00000.bin")
        with open(data_path, "wb") as f:
            for key in sorted(flat):
                arr, dtype = flat[key]
                buf = arr.tobytes()
                index[key] = {"offset": offset, "nbytes": len(buf),
                              "shape": list(arr.shape),
                              "dtype": dtype,
                              "crc": zlib.crc32(buf) & 0xFFFFFFFF}
                f.write(buf)
                offset += len(buf)
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        meta = {"step": step, "n_tensors": len(flat),
                "created": time.time(), **metadata}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if not self.lease.held_by_me():
            # the lease was stolen (holder revoked mid-save): abort before
            # the rename so the contested write never becomes visible
            shutil.rmtree(tmp, ignore_errors=True)
            raise LeaseLostError(
                f"{self.lease.holder} lost writer.lease during save of "
                f"step {step}; commit aborted")
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        with open(os.path.join(self.root, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.root, "LATEST.tmp"),
                   os.path.join(self.root, "LATEST"))
        sizes = CheckpointSizes(
            offset,
            os.path.getsize(os.path.join(final, "index.json")),
            os.path.getsize(os.path.join(final, "meta.json")))
        self._gc()
        return sizes

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        """Committed step numbers, hardened against stray entries: only
        directories named exactly ``step_<int>`` count — a leftover
        ``step_backup`` file or half-written ``.tmp_step_*`` dir must
        never break restore-or-init."""
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("step_"):
                continue
            tail = name[len("step_"):]
            if not tail.isdigit():
                continue
            if not os.path.isdir(os.path.join(self.root, name)):
                continue
            out.append(int(tail))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        try:
            with open(os.path.join(self.root, "LATEST")) as f:
                step = int(f.read().strip())
            # a stale pointer (step dir GC'd or lost) falls through to the
            # newest committed directory instead of a doomed restore
            if step in steps:
                return step
        except (FileNotFoundError, ValueError):
            pass
        return steps[-1] if steps else None

    def read_meta(self, step: Optional[int] = None) -> dict:
        """The meta.json of a committed checkpoint (structure + user
        metadata) without loading the array payload."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        with open(os.path.join(self.root, f"step_{step}", "meta.json")) as f:
            return json.load(f)

    def restore(self, tree_like, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """``tree_like``'s structure with each leaf read from the
        checkpoint: a tensor leaf becomes a new tensor with its dtype and
        device, any other leaf the stored array. A key the checkpoint does
        not hold raises `KeyError`."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        with open(os.path.join(d, "data-00000.bin"), "rb") as f:
            blob = f.read()

        def load(key, leaf):
            t = _from_record(blob, index[key])
            if not isinstance(leaf, torch.Tensor):
                return t.numpy()
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} "
                                 f"!= {tuple(leaf.shape)}")
            return t.to(device=leaf.device, dtype=leaf.dtype)

        return _rebuild(tree_like, load), step

    # ------------------------------------------------------------- integrity
    def validate(self, step: int) -> None:
        """Raise `CheckpointCorruptError` unless ``step_<step>`` is a
        complete, checksum-clean checkpoint: index/meta parse, the data
        payload covers every recorded extent, and each array's crc32
        matches (entries written before checksums existed get the extent
        check only)."""
        d = os.path.join(self.root, f"step_{step}")
        try:
            with open(os.path.join(d, "index.json")) as f:
                index = json.load(f)
            with open(os.path.join(d, "meta.json")) as f:
                json.load(f)
            with open(os.path.join(d, "data-00000.bin"), "rb") as f:
                blob = f.read()
        except (FileNotFoundError, NotADirectoryError,
                json.JSONDecodeError) as exc:
            raise CheckpointCorruptError(
                f"step {step}: unreadable checkpoint ({exc})") from exc
        for key, rec in index.items():
            end = rec["offset"] + rec["nbytes"]
            if end > len(blob):
                raise CheckpointCorruptError(
                    f"step {step}: torn payload — {key} needs bytes "
                    f"[{rec['offset']}, {end}) of {len(blob)}")
            if "crc" in rec:
                got = zlib.crc32(blob[rec["offset"]:end]) & 0xFFFFFFFF
                if got != rec["crc"]:
                    raise CheckpointCorruptError(
                        f"step {step}: checksum mismatch on {key} "
                        f"(stored {rec['crc']:#010x}, got {got:#010x})")

    def restore_latest_valid(self, tree_like,
                             on_fallback=None) -> Tuple[Any, int, int]:
        """Restore from the newest checkpoint that passes `validate`,
        falling back generation by generation past torn or corrupt ones
        instead of crashing or silently loading bad state. Returns
        ``(tree, step, depth)`` where ``depth`` counts skipped
        generations (0 = the latest was clean); ``on_fallback(step,
        error)`` is called for each one skipped. Raises
        `FileNotFoundError` when no checkpoint exists at all and
        `CheckpointCorruptError` when every one is damaged."""
        steps: List[int] = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        errors: List[str] = []
        latest = self.latest_step()
        # LATEST first, then the remaining committed steps newest-first
        order = [latest] + [s for s in sorted(steps, reverse=True)
                            if s != latest]
        for depth, step in enumerate(order):
            try:
                self.validate(step)
                tree, got = self.restore(tree_like, step=step)
                return tree, got, depth
            except CheckpointCorruptError as exc:
                errors.append(str(exc))
                if on_fallback is not None:
                    on_fallback(step, exc)
        raise CheckpointCorruptError(
            "every committed checkpoint failed validation: "
            + "; ".join(errors))

    def corrupt(self, step: int, nbytes: int = 16) -> None:
        """Test/chaos hook: flip the first `nbytes` of a committed step's
        payload in place, simulating a torn or bit-rotted write that the
        checksum fallback must detect and skip."""
        path = os.path.join(self.root, f"step_{step}", "data-00000.bin")
        with open(path, "r+b") as f:
            head = f.read(nbytes)
            f.seek(0)
            f.write(bytes(b ^ 0xFF for b in head))
