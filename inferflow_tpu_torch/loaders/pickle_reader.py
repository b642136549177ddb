"""Safe, non-executing pickle parser for PyTorch checkpoints.

A copy of inferflow_tpu/loaders/pickle_reader.py (no JAX in it), kept so
that this package imports nothing of the JAX one.

reference: src/common/pickle_reader.{h,cc} — a subset of the pickle VM with
a full opcode table and NO code execution, so `.bin`/`.pth` checkpoints can
be read without trusting them (the reference's security parity claim,
README.md:30).  This is a from-scratch Python implementation of the same
idea: every GLOBAL is resolved against a whitelist of *data constructors*
we implement ourselves; REDUCE/BUILD never call into user code and
`pickle`/`torch` are never imported.

Supports the PyTorch zip container (data.pkl + data/<key> storages) and the
legacy (pre-1.6) serialization stream (model_reader.cc:1742-2270 reads
both).
"""

from __future__ import annotations

import io
import struct
import zipfile
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

# storage class name -> (numpy dtype or 'bf16', itemsize)
STORAGE_DTYPES = {
    "FloatStorage": (np.float32, 4),
    "DoubleStorage": (np.float64, 8),
    "HalfStorage": (np.float16, 2),
    "BFloat16Storage": ("bf16", 2),
    "LongStorage": (np.int64, 8),
    "IntStorage": (np.int32, 4),
    "ShortStorage": (np.int16, 2),
    "CharStorage": (np.int8, 1),
    "ByteStorage": (np.uint8, 1),
    "BoolStorage": (np.bool_, 1),
}


class StorageRef:
    """A persistent-id reference to a storage blob."""

    __slots__ = ("key", "dtype_name", "numel", "location")

    def __init__(self, key: str, dtype_name: str, numel: int, location: str):
        self.key = key
        self.dtype_name = dtype_name
        self.numel = numel
        self.location = location


class TensorStub:
    """Result of _rebuild_tensor_v2: metadata + a storage reference."""

    __slots__ = ("storage", "offset", "shape", "stride", "requires_grad")

    def __init__(self, storage: StorageRef, offset: int, shape: tuple,
                 stride: tuple, requires_grad: bool = False):
        self.storage = storage
        self.offset = offset
        self.shape = tuple(int(s) for s in shape)
        self.stride = tuple(int(s) for s in stride)
        self.requires_grad = requires_grad


class _Mark:
    pass


def _rebuild_tensor_v2(storage, offset, shape, stride, requires_grad=False,
                       backward_hooks=None, metadata=None):
    return TensorStub(storage, offset, shape, stride, bool(requires_grad))


def _rebuild_tensor(storage, offset, shape, stride):
    return TensorStub(storage, offset, shape, stride)


def _rebuild_parameter(tensor, requires_grad=False, backward_hooks=None):
    return tensor


class _Global:
    """A whitelisted global: either a constructor we implement, or an inert
    named marker (storage classes, torch.Size)."""

    def __init__(self, module: str, name: str, fn=None):
        self.module = module
        self.name = name
        self.fn = fn

    def __call__(self, *args):
        if self.fn is None:
            raise UnpicklingError(
                f"global {self.module}.{self.name} is not callable")
        return self.fn(*args)


_SAFE_GLOBALS = {
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_tensor"): _rebuild_tensor,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("collections", "OrderedDict"): lambda *a: dict(a[0]) if a else {},
    ("torch", "Size"): lambda t: tuple(t),
    ("torch.serialization", "_get_layout"): lambda name: name,
    ("__builtin__", "set"): lambda *a: set(a[0]) if a else set(),
    ("builtins", "set"): lambda *a: set(a[0]) if a else set(),
}


class UnpicklingError(Exception):
    pass


class SafeUnpickler:
    """Pickle VM subset (protocols 0-5), data-only.

    Mirrors the opcode coverage of the reference's PickleReader
    (pickle_reader.h:43-100).  Any opcode or global outside the supported
    set raises UnpicklingError instead of executing anything.
    """

    def __init__(self, fh: BinaryIO, persistent_load=None):
        self.fh = fh
        self.stack: List[Any] = []
        self.memo: Dict[int, Any] = {}
        self.persistent_load = persistent_load or (lambda pid: pid)

    # -- helpers ---------------------------------------------------------
    def _read(self, n: int) -> bytes:
        b = self.fh.read(n)
        if len(b) != n:
            raise UnpicklingError("truncated pickle stream")
        return b

    def _readline(self) -> bytes:
        out = bytearray()
        while True:
            c = self._read(1)
            if c == b"\n":
                return bytes(out)
            out += c

    def _pop_mark(self) -> List[Any]:
        items: List[Any] = []
        while True:
            if not self.stack:
                raise UnpicklingError("mark not found")
            top = self.stack.pop()
            if isinstance(top, _Mark):
                items.reverse()
                return items
            items.append(top)

    def _memo_put(self, idx: int):
        self.memo[idx] = self.stack[-1]

    def _global(self, module: str, name: str):
        key = (module, name)
        if key in _SAFE_GLOBALS:
            return _Global(module, name, _SAFE_GLOBALS[key])
        if module == "torch" and name in STORAGE_DTYPES:
            return _Global(module, name)  # inert marker
        raise UnpicklingError(f"disallowed global: {module}.{name}")

    def _reduce(self, func, args):
        if not isinstance(func, _Global):
            raise UnpicklingError("REDUCE on non-global")
        return func(*args)

    # -- main loop -------------------------------------------------------
    def load(self) -> Any:
        while True:
            op = self._read(1)
            meth = _DISPATCH.get(op)
            if meth is None:
                raise UnpicklingError(f"unsupported pickle opcode {op!r}")
            result = meth(self)
            if result is _STOP:
                return self.stack.pop()


_STOP = object()
_DISPATCH = {}


def _op(code: bytes):
    def deco(fn):
        _DISPATCH[code] = fn
        return fn
    return deco


@_op(b"\x80")
def _proto(u):
    u._read(1)


@_op(b"\x95")
def _frame(u):
    u._read(8)


@_op(b".")
def _stop(u):
    return _STOP


@_op(b"(")
def _mark(u):
    u.stack.append(_Mark())


@_op(b"N")
def _none(u):
    u.stack.append(None)


@_op(b"\x88")
def _true(u):
    u.stack.append(True)


@_op(b"\x89")
def _false(u):
    u.stack.append(False)


@_op(b"K")
def _binint1(u):
    u.stack.append(u._read(1)[0])


@_op(b"M")
def _binint2(u):
    u.stack.append(struct.unpack("<H", u._read(2))[0])


@_op(b"J")
def _binint(u):
    u.stack.append(struct.unpack("<i", u._read(4))[0])


@_op(b"\x8a")
def _long1(u):
    n = u._read(1)[0]
    data = u._read(n)
    u.stack.append(int.from_bytes(data, "little", signed=True))


@_op(b"L")
def _long(u):
    line = u._readline().rstrip(b"L")
    u.stack.append(int(line))


@_op(b"I")
def _int_text(u):
    line = u._readline()
    if line == b"01":
        u.stack.append(True)
    elif line == b"00":
        u.stack.append(False)
    else:
        u.stack.append(int(line))


@_op(b"G")
def _binfloat(u):
    u.stack.append(struct.unpack(">d", u._read(8))[0])


@_op(b"F")
def _float_text(u):
    u.stack.append(float(u._readline()))


@_op(b"X")
def _binunicode(u):
    n = struct.unpack("<I", u._read(4))[0]
    u.stack.append(u._read(n).decode("utf-8", "surrogatepass"))


@_op(b"\x8c")
def _short_binunicode(u):
    n = u._read(1)[0]
    u.stack.append(u._read(n).decode("utf-8", "surrogatepass"))


@_op(b"\x8d")
def _binunicode8(u):
    n = struct.unpack("<Q", u._read(8))[0]
    u.stack.append(u._read(n).decode("utf-8", "surrogatepass"))


@_op(b"U")
def _short_binstring(u):
    n = u._read(1)[0]
    u.stack.append(u._read(n).decode("latin-1"))


@_op(b"T")
def _binstring(u):
    n = struct.unpack("<i", u._read(4))[0]
    u.stack.append(u._read(n).decode("latin-1"))


@_op(b"C")
def _short_binbytes(u):
    n = u._read(1)[0]
    u.stack.append(u._read(n))


@_op(b"B")
def _binbytes(u):
    n = struct.unpack("<I", u._read(4))[0]
    u.stack.append(u._read(n))


@_op(b"\x8e")
def _binbytes8(u):
    n = struct.unpack("<Q", u._read(8))[0]
    u.stack.append(u._read(n))


@_op(b"\x96")
def _bytearray8(u):
    n = struct.unpack("<Q", u._read(8))[0]
    u.stack.append(bytearray(u._read(n)))


@_op(b"]")
def _empty_list(u):
    u.stack.append([])


@_op(b"}")
def _empty_dict(u):
    u.stack.append({})


@_op(b"\x8f")
def _empty_set(u):
    u.stack.append(set())


@_op(b")")
def _empty_tuple(u):
    u.stack.append(())


@_op(b"t")
def _tuple(u):
    u.stack.append(tuple(u._pop_mark()))


@_op(b"\x85")
def _tuple1(u):
    u.stack[-1] = (u.stack[-1],)


@_op(b"\x86")
def _tuple2(u):
    b = u.stack.pop()
    u.stack[-1] = (u.stack[-1], b)


@_op(b"\x87")
def _tuple3(u):
    c = u.stack.pop()
    b = u.stack.pop()
    u.stack[-1] = (u.stack[-1], b, c)


@_op(b"l")
def _list(u):
    u.stack.append(u._pop_mark())


@_op(b"d")
def _dict(u):
    items = u._pop_mark()
    u.stack.append({items[i]: items[i + 1] for i in range(0, len(items), 2)})


@_op(b"a")
def _append(u):
    v = u.stack.pop()
    u.stack[-1].append(v)


@_op(b"e")
def _appends(u):
    items = u._pop_mark()
    u.stack[-1].extend(items)


@_op(b"\x90")
def _additems(u):
    items = u._pop_mark()
    u.stack[-1].update(items)


@_op(b"s")
def _setitem(u):
    v = u.stack.pop()
    k = u.stack.pop()
    u.stack[-1][k] = v


@_op(b"u")
def _setitems(u):
    items = u._pop_mark()
    d = u.stack[-1]
    for i in range(0, len(items), 2):
        d[items[i]] = items[i + 1]


@_op(b"q")
def _binput(u):
    u._memo_put(u._read(1)[0])


@_op(b"r")
def _long_binput(u):
    u._memo_put(struct.unpack("<I", u._read(4))[0])


@_op(b"\x94")
def _memoize(u):
    u.memo[len(u.memo)] = u.stack[-1]


@_op(b"h")
def _binget(u):
    u.stack.append(u.memo[u._read(1)[0]])


@_op(b"j")
def _long_binget(u):
    u.stack.append(u.memo[struct.unpack("<I", u._read(4))[0]])


@_op(b"c")
def _global_text(u):
    module = u._readline().decode("utf-8")
    name = u._readline().decode("utf-8")
    u.stack.append(u._global(module, name))


@_op(b"\x93")
def _stack_global(u):
    name = u.stack.pop()
    module = u.stack.pop()
    u.stack.append(u._global(module, name))


@_op(b"R")
def _reduce_op(u):
    args = u.stack.pop()
    func = u.stack.pop()
    u.stack.append(u._reduce(func, args))


@_op(b"b")
def _build(u):
    state = u.stack.pop()
    obj = u.stack[-1]
    # data-only: merge dict state into dict objects; ignore otherwise
    if isinstance(obj, dict) and isinstance(state, dict):
        obj.update(state)


@_op(b"Q")
def _binpersid(u):
    pid = u.stack.pop()
    u.stack.append(u.persistent_load(pid))


@_op(b"P")
def _persid_text(u):
    pid = u._readline().decode("utf-8")
    u.stack.append(u.persistent_load(pid))


@_op(b"\x82")
def _ext1(u):
    raise UnpicklingError("EXT opcodes not allowed")


@_op(b"0")
def _pop(u):
    u.stack.pop()


@_op(b"1")
def _pop_mark_op(u):
    u._pop_mark()


@_op(b"2")
def _dup(u):
    u.stack.append(u.stack[-1])


# -- PyTorch containers ---------------------------------------------------

def _storage_persistent_load(pid) -> StorageRef:
    """torch persistent id: ('storage', <StorageType>, key, location, numel)"""
    if not (isinstance(pid, tuple) and len(pid) >= 5 and pid[0] == "storage"):
        raise UnpicklingError(f"unsupported persistent id: {pid!r}")
    storage_type, key, location, numel = pid[1], pid[2], pid[3], pid[4]
    if isinstance(storage_type, _Global):
        name = storage_type.name
    else:
        name = str(storage_type)
    if name not in STORAGE_DTYPES:
        raise UnpicklingError(f"unknown storage type {name}")
    return StorageRef(str(key), name, int(numel), str(location))


def _stub_to_array(stub: TensorStub, raw: bytes) -> np.ndarray:
    dtype, itemsize = STORAGE_DTYPES[stub.storage.dtype_name]
    count = int(np.prod(stub.shape)) if stub.shape else 1
    if dtype == "bf16":
        u16 = np.frombuffer(raw, dtype=np.uint16,
                            count=count, offset=stub.offset * itemsize)
        flat = (u16.astype(np.uint32) << 16).view(np.float32)
    else:
        flat = np.frombuffer(raw, dtype=dtype, count=count,
                             offset=stub.offset * itemsize)
    # contiguous strides only (checkpoint tensors are contiguous)
    return flat.reshape(stub.shape)


def load_torch_zip(path: str) -> Dict[str, np.ndarray]:
    """Read a PyTorch zip checkpoint (torch >= 1.6 .bin/.pth)."""
    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf:
        pkl_names = [n for n in zf.namelist() if n.endswith("data.pkl")]
        if not pkl_names:
            raise UnpicklingError(f"{path}: no data.pkl (not a torch zip)")
        pkl_name = pkl_names[0]
        prefix = pkl_name[: -len("data.pkl")]
        with zf.open(pkl_name) as fh:
            obj = SafeUnpickler(io.BytesIO(fh.read()),
                                _storage_persistent_load).load()
        state = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        if not isinstance(state, dict):
            raise UnpicklingError("checkpoint root is not a dict")
        for name, val in state.items():
            if isinstance(val, TensorStub):
                raw = zf.read(f"{prefix}data/{val.storage.key}")
                out[str(name)] = _stub_to_array(val, raw)
    return out


_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C


def load_torch_legacy(path: str) -> Dict[str, np.ndarray]:
    """Read a legacy (pre-1.6) PyTorch serialization stream."""
    with open(path, "rb") as fh:
        magic = SafeUnpickler(fh).load()
        if magic != _LEGACY_MAGIC:
            raise UnpicklingError(f"{path}: bad legacy magic {magic!r}")
        SafeUnpickler(fh).load()  # protocol version
        SafeUnpickler(fh).load()  # sys info
        refs: List[StorageRef] = []

        def pload(pid):
            ref = _storage_persistent_load(pid)
            refs.append(ref)
            return ref

        obj = SafeUnpickler(fh, pload).load()
        state = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        # deserialized storages follow: key list pickle, then per-storage
        # (u64-le numel + raw data), in the order keys were first seen
        keys = SafeUnpickler(fh).load()
        storages: Dict[str, bytes] = {}
        by_key = {r.key: r for r in refs}
        for key in keys:
            numel = struct.unpack("<q", fh.read(8))[0]
            ref = by_key[str(key)]
            _, itemsize = STORAGE_DTYPES[ref.dtype_name]
            storages[str(key)] = fh.read(numel * itemsize)
    out = {}
    for name, val in state.items():
        if isinstance(val, TensorStub):
            out[str(name)] = _stub_to_array(val, storages[val.storage.key])
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Auto-detect zip vs legacy torch checkpoint (model_reader.cc pickle
    path handles both containers)."""
    if zipfile.is_zipfile(path):
        return load_torch_zip(path)
    return load_torch_legacy(path)
