"""Minimal netCDF4 (HDF5) writer.

Port of mpas_tpu/io/hdf5_write.py: numpy only, the same arithmetic; the port
keeps its own copy so that it imports nothing of the JAX package.

Emits the classic-model netCDF4 layout the netCDF4 C library produces:
superblock v0, v1 object headers, a v1 symbol-table root group (B-tree +
SNOD + local heap), dimension-scale datasets (CLASS=DIMENSION_SCALE /
NAME / _Netcdf4Dimid), per-variable DIMENSION_LIST vlen-reference
attributes via a global heap, and contiguous or chunked+deflate+shuffle
data layouts with v1 chunk B-trees. Readable by h5py/netCDF4/ncdump —
and by io/hdf5.py, giving a full round-trip test of the ingest path.

ref parity: the writer side of mpas_io.F's MPAS_IO_NETCDF4 iotype
(src/framework/mpas_io.F:144-200).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF


def _pad8(b):
    return b + b"\x00" * ((-len(b)) % 8)


def _dt_msg(dtype):
    """Datatype message body for a numpy dtype (little-endian)."""
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        b0 = (1 << 4) | 0
        bits0 = 0x08 if dt.kind == "i" else 0x00
        body = struct.pack("<BBBBI", b0, bits0, 0, 0, dt.itemsize)
        body += struct.pack("<HH", 0, dt.itemsize * 8)
        return body
    if dt.kind == "f":
        b0 = (1 << 4) | 1
        bits0 = 0x20  # IEEE: sign at msb... (bit field: byte order 0=LE)
        if dt.itemsize == 4:
            body = struct.pack("<BBBBI", b0, 0x00, 31, 0, 4)
            body += struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
        else:
            body = struct.pack("<BBBBI", b0, 0x00, 63, 0, 8)
            body += struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
        return body
    if dt.kind == "S":
        b0 = (1 << 4) | 3
        return struct.pack("<BBBBI", b0, 0, 0, 0, dt.itemsize)
    raise ValueError(f"unsupported dtype {dt}")


def _ref_dt_msg():
    # class 7 (reference), object reference
    return struct.pack("<BBBBI", (1 << 4) | 7, 0, 0, 0, 8)


def _vlen_ref_dt_msg():
    # class 9 (vlen), base type = object reference; bits0 vtype=0 (sequence)
    return struct.pack("<BBBBI", (1 << 4) | 9, 0, 0, 0, 16) + _ref_dt_msg()


def _ds_msg(shape):
    body = struct.pack("<BBBBI", 1, len(shape), 1, 0, 0)
    for s in shape:
        body += struct.pack("<Q", s)
    for s in shape:
        body += struct.pack("<Q", s)
    return body


def _attr_msg(name, dtype_body, ds_body, value_bytes):
    nb = name.encode() + b"\x00"
    body = struct.pack("<BBHHH", 1, 0, len(nb), len(dtype_body),
                       len(ds_body))
    body += _pad8(nb) + _pad8(dtype_body) + _pad8(ds_body) + value_bytes
    return body


def _num_attr(name, value):
    arr = np.atleast_1d(np.asarray(value))
    shape = () if np.isscalar(value) or np.asarray(value).ndim == 0 \
        else arr.shape
    return _attr_msg(name, _dt_msg(arr.dtype),
                     _ds_msg(arr.shape if shape else ()),
                     arr.tobytes())


def _str_attr(name, s):
    sb = s.encode() + b"\x00"
    return _attr_msg(name, _dt_msg(np.dtype(f"S{len(sb)}")), _ds_msg(()),
                     sb)


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def tell(self):
        return len(self.buf)

    def write(self, b):
        off = len(self.buf)
        self.buf += b
        return off

    def patch(self, off, b):
        self.buf[off:off + len(b)] = b


def _object_header(msgs):
    """v1 object header from a list of (type, body) messages."""
    hdr_msgs = b""
    for mtype, body in msgs:
        body = _pad8(body)
        hdr_msgs += struct.pack("<HHI", mtype, len(body), 0) + body
    # v1 prefix is 12 bytes + 4 alignment-pad bytes; messages start at +16
    return struct.pack("<BBHII", 1, 0, len(msgs), 1,
                       len(hdr_msgs)) + b"\x00" * 4 + hdr_msgs


def _chunk_btree(w, chunks, rank):
    """Write a v1 chunk B-tree (single leaf; fan out if needed).
    chunks: list of (offset_tuple, data_addr, nbytes)."""
    key_size = 8 + 8 * (rank + 1)

    def leaf(entries, left, right):
        body = b"TREE" + struct.pack("<BBH", 1, 0, len(entries))
        body += struct.pack("<QQ", left, right)
        for coff, addr, nb in entries:
            body += struct.pack("<IHH", nb, 0, 0)
            for c in coff:
                body += struct.pack("<Q", c)
            body += struct.pack("<Q", 0)  # elem offset (itemsize dim)
            body += struct.pack("<Q", addr)
        # final key
        last = entries[-1]
        body += struct.pack("<IHH", 0, 0, 0)
        for c in last[0]:
            body += struct.pack("<Q", 0)
        body += struct.pack("<Q", 0)
        return w.write(body)

    # single leaf handles <= 2**16 entries; model files fit easily
    return leaf(chunks, UNDEF, UNDEF)


def write_hdf5(path, dims: dict, variables: dict, attrs: dict = None,
               compress: bool = False, chunk_rows: int = 0):
    """Write a netCDF4-style HDF5 file.

    dims: {name: size}; variables: {name: (dim_names_tuple, ndarray)}.
    compress=True stores 2D+ variables chunked with shuffle+deflate.
    """
    w = _Writer()
    w.write(b"\x89HDF\r\n\x1a\n")
    # superblock v0: vsb, vfs, vroot, rsvd, vshm, size_off, size_len, rsvd,
    # leaf_k, internal_k, flags
    sb = struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0)
    w.write(sb)
    w.write(struct.pack("<QQQQ", 0, UNDEF, 0, UNDEF))  # base,free,eof,drv
    root_ste_off = w.write(struct.pack("<QQIIQQ", 0, 0, 0, 0, 0, 0))

    # plan objects: dims (as dimension-scale datasets) then variables
    order = []
    dim_list = list(dims.items())
    dimid = {name: i for i, (name, _) in enumerate(dim_list)}
    var_items = {k: (tuple(dn), np.ascontiguousarray(np.asarray(a)))
                 for k, (dn, a) in variables.items()}
    # a dimension that is also a variable = coordinate variable
    objects = {}
    for dname, dsize in dim_list:
        objects[dname] = ("dim", dsize)
    for vname in var_items:
        if vname not in objects:
            objects[vname] = ("var",)

    # first pass: write all raw data, record addresses
    data_addr = {}
    chunk_info = {}
    for vname, (dnames, arr) in var_items.items():
        if arr.dtype == np.int64:
            arr = arr.astype(np.int64)  # keep: HDF5 supports i8
        if compress and arr.ndim >= 1 and arr.size > 64:
            cshape = list(arr.shape)
            if chunk_rows and arr.shape[0] > chunk_rows:
                cshape[0] = chunk_rows
            chunks = []
            n0 = arr.shape[0]
            step = cshape[0]
            for o in range(0, n0, step):
                block = np.zeros(cshape, arr.dtype)
                take = min(step, n0 - o)
                block[:take] = arr[o:o + take]
                raw = block.tobytes()
                es = arr.dtype.itemsize
                a8 = np.frombuffer(raw, np.uint8)
                shuf = a8.reshape(-1, es).T.tobytes()
                comp = zlib.compress(shuf, 4)
                addr = w.write(comp)
                chunks.append(((o,) + (0,) * (arr.ndim - 1),
                               addr, len(comp)))
            chunk_info[vname] = (tuple(cshape), chunks)
        else:
            data_addr[vname] = w.write(arr.tobytes())

    # second pass: object headers — dims first (vars reference them)
    hdr_addr = {}
    gheap_entries = []  # (bytes) for DIMENSION_LIST vlens

    def dim_scale_msgs(dname, dsize, arr=None):
        dt = np.float64 if arr is None else arr.dtype
        shape = (dsize,)
        msgs = [(0x01, _ds_msg(shape)), (0x03, _dt_msg(dt))]
        if arr is not None:
            msgs.append((0x08, struct.pack("<BBQQ", 3, 1,
                                           data_addr[dname],
                                           arr.nbytes)))
        else:
            msgs.append((0x08, struct.pack("<BBQQ", 3, 1, UNDEF,
                                           dsize * 8)))
        msgs.append((0x0C, _str_attr("CLASS", "DIMENSION_SCALE")))
        if arr is None:
            msgs.append((0x0C, _str_attr(
                "NAME", "This is a netCDF dimension but not a netCDF "
                f"variable.{' ' * 0}{dsize:10d}")))
        else:
            msgs.append((0x0C, _str_attr("NAME", dname)))
        msgs.append((0x0C, _num_attr("_Netcdf4Dimid",
                                     np.int32(dimid[dname]))))
        return msgs

    for dname, dsize in dim_list:
        arr = var_items[dname][1] if dname in var_items else None
        hdr_addr[dname] = w.write(_object_header(
            dim_scale_msgs(dname, dsize, arr)))

    # variables (non-dim)
    gheap_addr_off = []  # patches: (buf_off, vname)
    var_hdr_plan = {}
    for vname, (dnames, arr) in var_items.items():
        if vname in dims:
            continue
        msgs = [(0x01, _ds_msg(arr.shape)), (0x03, _dt_msg(arr.dtype))]
        if vname in chunk_info:
            cshape, chunks = chunk_info[vname]
            btree_addr = _chunk_btree(w, [
                (c[0], c[1], c[2]) for c in chunks], arr.ndim + 1)
            rank = arr.ndim + 1
            lay = struct.pack("<BBB", 3, 2, rank) + struct.pack(
                "<Q", btree_addr)
            for c in cshape:
                lay += struct.pack("<I", c)
            lay += struct.pack("<I", arr.dtype.itemsize)
            msgs.append((0x08, lay))
            # filter pipeline v1: shuffle(2) then deflate(1)
            fp = struct.pack("<BBHI", 1, 2, 0, 0)
            nameb = _pad8(b"shuffle\x00")
            fp += struct.pack("<HHHH", 2, len(nameb), 1, 1) + nameb
            fp += struct.pack("<I", arr.dtype.itemsize) + struct.pack("<I", 0)
            nameb = _pad8(b"deflate\x00")
            fp += struct.pack("<HHHH", 1, len(nameb), 1, 1) + nameb
            fp += struct.pack("<I", 4) + struct.pack("<I", 0)
            msgs.append((0x0B, fp))
        else:
            msgs.append((0x08, struct.pack("<BBQQ", 3, 1,
                                           data_addr[vname], arr.nbytes)))
        # DIMENSION_LIST attribute (vlen of object refs, via global heap)
        if dnames:
            refs = [hdr_addr[dn] for dn in dnames]
            gidx_base = len(gheap_entries) + 1
            for r in refs:
                gheap_entries.append(struct.pack("<Q", r))
            val = b""
            for j, r in enumerate(refs):
                val += struct.pack("<IQI", 1, 0, gidx_base + j)
            # gheap addr (the 0 above) patched later: record positions
            msgs.append((0x0C, _attr_msg("DIMENSION_LIST",
                                         _vlen_ref_dt_msg(),
                                         _ds_msg((len(refs),)), val)))
        var_hdr_plan[vname] = msgs

    for vname, msgs in var_hdr_plan.items():
        hdr_addr[vname] = w.write(_object_header(msgs))

    # global heap for DIMENSION_LIST refs
    if gheap_entries:
        objs = b""
        for i, e in enumerate(gheap_entries):
            objs += struct.pack("<HHI", i + 1, 1, 0) + struct.pack(
                "<Q", len(e)) + _pad8(e)
        total = 16 + len(objs)
        total_padded = max(total, 4096)
        gh = b"GCOL" + struct.pack("<BBH", 1, 0, 0) + struct.pack(
            "<Q", total_padded)
        gh += objs + b"\x00" * (total_padded - total)
        gheap_addr = w.write(gh)
        # patch every DIMENSION_LIST vlen's heap address: scan headers
        for vname in var_hdr_plan:
            base = hdr_addr[vname]
            # find the attr message bodies and patch (IQI) entries
            raw = bytes(w.buf[base:base + 8192])
            pos = raw.find(b"DIMENSION_LIST")
            if pos < 0:
                continue
            # value starts after padded name + padded dt (24) + padded ds
            dn = var_items[vname][0]
            nrefs = len(dn)
            # locate by pattern: count IQI tuples with len 1
            p = pos
            # brute scan for the vlen entries: 16-byte groups of
            # (1, 0, idx) — patch the Q field
            q = pos
            found = 0
            while q < len(raw) - 16 and found < nrefs:
                ln, ga, ix = struct.unpack("<IQI", raw[q:q + 16])
                if ln == 1 and ga == 0 and 1 <= ix <= len(gheap_entries):
                    w.patch(base + q + 4, struct.pack("<Q", gheap_addr))
                    found += 1
                    q += 16
                else:
                    q += 1

    # root group: local heap + SNOD + B-tree + root header
    names = sorted(hdr_addr)  # B-tree requires sorted symbol entries
    heap_data = bytearray(b"\x00" * 8)
    name_off = {}
    for n in names:
        name_off[n] = len(heap_data)
        heap_data += n.encode() + b"\x00"
        heap_data += b"\x00" * ((-len(heap_data)) % 8)
    heap_data_addr = None
    heap_hdr = b"HEAP" + struct.pack("<BBH", 0, 0, 0)
    heap_hdr += struct.pack("<QQQ", len(heap_data), 0, 0)
    heap_addr = w.write(heap_hdr)
    # patch data addr after writing data segment
    hd_addr = w.write(bytes(heap_data))
    w.patch(heap_addr + 8 + 16, struct.pack("<Q", hd_addr))

    snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names))
    for n in names:
        snod += struct.pack("<QQIIQQ", name_off[n], hdr_addr[n], 0, 0, 0, 0)
    snod_addr = w.write(snod)

    bt = b"TREE" + struct.pack("<BBH", 0, 0, 1)
    bt += struct.pack("<QQ", UNDEF, UNDEF)
    bt += struct.pack("<Q", 0)                      # key 0
    bt += struct.pack("<Q", snod_addr)
    bt += struct.pack("<Q", name_off[names[-1]])    # key 1
    btree_addr = w.write(bt)

    root_msgs = [(0x11, struct.pack("<QQ", btree_addr, heap_addr))]
    for k, v in (attrs or {}).items():
        if k == "__vardims__":
            continue
        if isinstance(v, str):
            root_msgs.append((0x0C, _str_attr(k, v)))
        else:
            root_msgs.append((0x0C, _num_attr(k, v)))
    root_hdr = w.write(_object_header(root_msgs))
    # patch superblock root symbol-table entry
    w.patch(root_ste_off, struct.pack("<QQIIQQ", 0, root_hdr, 1, 0,
                                      btree_addr, heap_addr))
    # eof address (superblock: base@24, freespace@32, eof@40)
    w.patch(40, struct.pack("<Q", len(w.buf)))

    with open(path, "wb") as f:
        f.write(bytes(w.buf))
