"""Serializable message layer: json header + npz array payload.

Counterpart of `repro/fed/runtime/messages.py`, on the same wire format,
so a frame of either package decodes in the other and the same message
encodes to the same bytes in both.  Every runtime message crosses the
wire as one byte string:

    [4-byte big-endian header length][json header][npz of the arrays]

The header carries the kind and json-safe scalars (worker id, iteration,
epoch, sequence number); a tree payload travels as its flattened leaves
under positional keys ("g1/0", "g1/1", ...), numbered in the reference's
leaf order (`utils.tree.tree_leaves`: dict keys sorted, state
dataclasses by field).  Treedefs never cross the wire: both ends rebuild
the same problem and unflatten against local templates.  No pickle.

A tensor leaves the device as contiguous numpy of its own dtype; a dtype
numpy cannot store without pickle (bf16, float8) raises rather than
being cast.  The in-process transport carries encoded frames too, so
every test exercises the real wire format.
"""
from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

HELLO, PUSH, REFRESH, STOP = "hello", "push", "refresh", "stop"
# HEARTBEAT keeps a silent-but-alive worker out of the dead set;
# DISCONNECT never crosses the wire: a transport reader or a chaos
# supervisor makes it locally, so the master tells "slow" from "gone"
HEARTBEAT, DISCONNECT = "heartbeat", "disconnect"
# elastic admission: an id beyond the launch population opens with
# ADMIT; the master grows at the next iteration boundary and replies
# WELCOME (the grown width and the boundary iteration), then the rows
ADMIT, WELCOME = "admit", "welcome"


@dataclasses.dataclass
class Message:
    """One wire message: a kind tag, json-safe `meta` scalars, and named
    array leaves."""
    kind: str
    meta: Dict
    arrays: Dict[str, np.ndarray]


def encode(msg: Message) -> bytes:
    """`Message` -> one self-delimiting byte frame."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in msg.arrays.items()})
    header = json.dumps({"kind": msg.kind, "meta": msg.meta}).encode()
    return struct.pack(">I", len(header)) + header + buf.getvalue()


def _header(data: bytes) -> Optional[Dict]:
    try:
        (hlen,) = struct.unpack(">I", data[:4])
        return json.loads(data[4:4 + hlen].decode())
    except Exception:
        return None


def peek_kind(data: bytes) -> Optional[str]:
    """The frame's kind without decoding the arrays (None if the frame is
    truncated or corrupt)."""
    h = _header(data)
    return None if h is None else h.get("kind")


def peek_meta(data: bytes) -> Optional[Dict]:
    """The frame's meta dict without decoding the arrays (None if
    truncated or corrupt)."""
    h = _header(data)
    return None if h is None else h.get("meta")


def decode(data: bytes) -> Message:
    """Byte frame -> `Message` (arrays that would need pickle raise)."""
    (hlen,) = struct.unpack(">I", data[:4])
    header = json.loads(data[4:4 + hlen].decode())
    arrays: Dict[str, np.ndarray] = {}
    payload = data[4 + hlen:]
    if payload:
        with np.load(io.BytesIO(payload), allow_pickle=False) as npz:
            arrays = {k: npz[k] for k in npz.files}
    return Message(kind=header["kind"], meta=header["meta"], arrays=arrays)


# ---------------------------------------------------------------------------
# tree <-> named-leaf helpers
# ---------------------------------------------------------------------------

def to_wire(leaf) -> np.ndarray:
    """One leaf as contiguous numpy of its own dtype (a tensor leaves the
    device).  A dtype numpy cannot hold without pickle raises."""
    if torch.is_tensor(leaf):
        try:
            leaf = leaf.detach().cpu().numpy()
        except TypeError as e:
            raise TypeError(
                f"a {leaf.dtype} leaf cannot cross the wire: numpy has no "
                "such dtype and the wire format refuses pickle (cast it "
                "explicitly)") from e
    arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if arr.dtype.hasobject or arr.dtype.kind == "V":
        raise TypeError(f"a {arr.dtype} leaf cannot cross the wire without "
                        "pickle")
    return arr


def pack_trees(groups: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Flatten each named tree into positional leaf keys."""
    out: Dict[str, np.ndarray] = {}
    for name, tree in groups.items():
        for i, leaf in enumerate(tree_leaves(tree)):
            out[f"{name}/{i}"] = to_wire(leaf)
    return out


def unpack_tree(msg: Message, name: str, template):
    """Rebuild tree `name` (numpy leaves) against a local template; a
    leaf-count mismatch (a wire or format fault) raises."""
    n_leaves = len(tree_leaves(template))
    _, tdef = tree_flatten(template)
    leaves = []
    i = 0
    while f"{name}/{i}" in msg.arrays:
        leaves.append(msg.arrays[f"{name}/{i}"])
        i += 1
    if i != n_leaves:
        raise ValueError(
            f"message group {name!r} has {i} leaves; local template "
            f"expects {n_leaves}")
    return tree_unflatten(tdef, leaves)


# ---------------------------------------------------------------------------
# message constructors (the whole protocol surface)
# ---------------------------------------------------------------------------

def hello(worker: int, epoch: int = 0) -> Message:
    """Worker -> master handshake or rejoin.  `epoch` is the session
    counter: 0 first, bumped on every reconnect."""
    return Message(HELLO, {"worker": int(worker), "epoch": int(epoch)}, {})


def admit(worker: int, epoch: int = 0) -> Message:
    """Worker -> master: admission request for an id at or beyond the
    launch width (epoch as in `hello`)."""
    return Message(ADMIT, {"worker": int(worker), "epoch": int(epoch)}, {})


def welcome(worker: int, t_master: int, n_workers: int) -> Message:
    """Master -> worker: the admission grant at the boundary where the
    population grew to `n_workers`; the initial rows follow."""
    return Message(WELCOME, {"worker": int(worker), "t": int(t_master),
                             "n_workers": int(n_workers)}, {})


def heartbeat(worker: int, epoch: int = 0) -> Message:
    """Worker -> master liveness beacon (sent while idle)."""
    return Message(HEARTBEAT, {"worker": int(worker),
                               "epoch": int(epoch)}, {})


def disconnect(worker: int) -> Message:
    """LOCAL frame for a broken connection; never sent over a wire."""
    return Message(DISCONNECT, {"worker": int(worker)}, {})


def push(worker: int, n_pushes: int, grads: Sequence,
         epoch: int = 0) -> Message:
    """Worker -> master: the Eq. 16 gradient triple at the worker's
    current point.  (epoch, n_pushes) make every push consumed at most
    once."""
    g1, g2, g3 = grads
    return Message(PUSH, {"worker": int(worker), "n_pushes": int(n_pushes),
                          "epoch": int(epoch)},
                   pack_trees({"g1": g1, "g2": g2, "g3": g3}))


def push_grads(msg: Message, templates: Tuple) -> Tuple:
    """Decode a PUSH payload against (x1, x2, x3) row templates."""
    t1, t2, t3 = templates
    return (unpack_tree(msg, "g1", t1), unpack_tree(msg, "g2", t2),
            unpack_tree(msg, "g3", t3))


def refresh(worker: int, t_master: int, rows: Sequence) -> Message:
    """Master -> worker: the worker's local point (x1_j, x2_j, x3_j) as of
    master iteration `t_master`."""
    x1, x2, x3 = rows
    return Message(REFRESH, {"worker": int(worker), "t": int(t_master)},
                   pack_trees({"x1": x1, "x2": x2, "x3": x3}))


def refresh_rows(msg: Message, templates: Tuple) -> Tuple:
    """Decode a REFRESH payload against (x1, x2, x3) row templates."""
    t1, t2, t3 = templates
    return (unpack_tree(msg, "x1", t1), unpack_tree(msg, "x2", t2),
            unpack_tree(msg, "x3", t3))


def stop() -> Message:
    """Master -> worker: run complete, leave the compute loop."""
    return Message(STOP, {}, {})
