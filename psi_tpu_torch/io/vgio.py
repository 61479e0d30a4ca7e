"""vg protobuf graph reader/writer.

Implements the vg wire format from first principles: a gzip stream of
chunks, each chunk = varint64 message count followed by (varint32 size +
message bytes) per message (framing per the public vg stream convention;
ref: vg/stream.hpp:24-60). The protobuf messages are decoded with a
minimal hand-rolled wire-format parser — only the fields the engine needs
(Graph.node/edge/path, Node.id/sequence, Edge.from/to/orientations,
Path.name/mapping, Mapping.position/rank, Position.node_id; schema field
numbers per the public vg.proto).
"""

from __future__ import annotations

import gzip
import struct
from typing import Dict, Iterator, List, Tuple

from psi_tpu_torch.graph import Graph

# --- protobuf wire primitives ----------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(msg: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(msg)
    while pos < n:
        key, pos = _read_varint(msg, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(msg, pos)
        elif wtype == 1:  # 64-bit
            val = struct.unpack_from("<Q", msg, pos)[0]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(msg, pos)
            val = msg[pos: pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = struct.unpack_from("<I", msg, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, val


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_field(out: bytearray, field: int, wtype: int, value) -> None:
    _write_varint(out, (field << 3) | wtype)
    if wtype == 0:
        _write_varint(out, value)
    elif wtype == 2:
        _write_varint(out, len(value))
        out.extend(value)
    else:
        raise ValueError(f"unsupported wire type {wtype}")


# --- vg message decoding ----------------------------------------------------


def _decode_node(msg: memoryview) -> Tuple[int, str]:
    nid, seq = 0, ""
    for field, _, val in _iter_fields(msg):
        if field == 3:
            nid = val
        elif field == 1:
            seq = bytes(val).decode("ascii")
    return nid, seq


def _decode_edge(msg: memoryview) -> Tuple[int, int, bool, bool]:
    f = t = 0
    from_start = to_end = False
    for field, _, val in _iter_fields(msg):
        if field == 1:
            f = val
        elif field == 2:
            t = val
        elif field == 3:
            from_start = bool(val)
        elif field == 4:
            to_end = bool(val)
    return f, t, from_start, to_end


def _decode_position_node(msg: memoryview) -> Tuple[int, bool]:
    nid, is_rev = 0, False
    for field, _, val in _iter_fields(msg):
        if field == 1:
            nid = val
        elif field == 4:  # Position.is_reverse (ref: vg/vg.proto:29-34)
            is_rev = bool(val)
    return nid, is_rev


def _decode_mapping(msg: memoryview) -> Tuple[int, int, str]:
    node_id, rank, orient = 0, 0, "+"
    for field, _, val in _iter_fields(msg):
        if field == 1:
            node_id, is_rev = _decode_position_node(val)
            orient = "-" if is_rev else "+"
        elif field == 5:
            rank = val
    return node_id, rank, orient


def _decode_path(msg: memoryview) -> Tuple[str, List[Tuple[int, int, str]]]:
    name = ""
    mappings: List[Tuple[int, int, str]] = []
    for field, _, val in _iter_fields(msg):
        if field == 1:
            name = bytes(val).decode("utf-8")
        elif field == 2:
            mappings.append(_decode_mapping(val))
    return name, mappings


def iter_vg_messages(path: str) -> Iterator[memoryview]:
    """Yield raw vg::Graph message chunks from a .vg stream file.

    Handles both the legacy untagged framing (varint count + sized messages)
    and the type-tagged framing where each group's first message is a short
    uppercase type tag such as b"VG".
    """
    with gzip.open(path, "rb") as fh:
        data = memoryview(fh.read())
    pos = 0
    n = len(data)
    while pos < n:
        count, pos = _read_varint(data, pos)
        for i in range(count):
            size, pos = _read_varint(data, pos)
            msg = data[pos: pos + size]
            pos += size
            if i == 0 and size <= 8 and bytes(msg).isalpha() and bytes(msg).isupper():
                continue  # type tag, e.g. b"VG"
            yield msg


def load_vg(path: str) -> Graph:
    """Load and merge all vg::Graph chunks from a .vg file
    (chunk merge mirrors gum::util::merge_vg usage,
    ref: test/src/test_seedfinder.cpp:36-44)."""
    nodes: Dict[int, str] = {}
    oedges: List[Tuple[int, str, int, str]] = []
    path_maps: Dict[str, List[Tuple[int, int, str]]] = {}
    path_order: List[str] = []

    for chunk in iter_vg_messages(path):
        for field, _, val in _iter_fields(chunk):
            if field == 1:  # node
                nid, seq = _decode_node(val)
                if nid:
                    nodes[nid] = seq
            elif field == 2:  # edge
                f, t, from_start, to_end = _decode_edge(val)
                # from_start: the edge leaves the reverse strand of f;
                # to_end: it enters the reverse strand of t
                # (ref: vg/vg.proto:36-47; normalized by node doubling)
                oedges.append(
                    (f, "-" if from_start else "+",
                     t, "-" if to_end else "+")
                )
            elif field == 3:  # path
                name, mappings = _decode_path(val)
                if name not in path_maps:
                    path_maps[name] = []
                    path_order.append(name)
                path_maps[name].extend(mappings)

    opaths: List[Tuple[str, List[Tuple[int, str]]]] = []
    for name in path_order:
        mappings = path_maps[name]
        # order mappings by 1-based rank when present, else keep stream order
        if any(r for _, r, _ in mappings):
            mappings = sorted(mappings, key=lambda m: m[1])
        opaths.append((name, [(nid, o) for nid, _, o in mappings]))

    from psi_tpu_torch.io.bidir import double_bidirected

    nodes, edges, paths, rc_base = double_bidirected(nodes, oedges, opaths)
    return Graph.from_parts(nodes, edges, paths, rc_base=rc_base)


# --- vg writing (used by pindexctl-style tools) -----------------------------


def encode_vg_graph(
    nodes: List[Tuple[int, str]],
    edges: List[Tuple[int, int]],
    paths: List[Tuple[str, List[int]]] = (),
) -> bytes:
    """Serialize one vg::Graph message."""
    out = bytearray()
    for nid, seq in nodes:
        node = bytearray()
        _write_field(node, 1, 2, seq.encode("ascii"))
        _write_field(node, 3, 0, nid)
        _write_field(out, 1, 2, bytes(node))
    for f, t in edges:
        edge = bytearray()
        _write_field(edge, 1, 0, f)
        _write_field(edge, 2, 0, t)
        _write_field(out, 2, 2, bytes(edge))
    for name, nids in paths:
        pmsg = bytearray()
        _write_field(pmsg, 1, 2, name.encode("utf-8"))
        for rank, nid in enumerate(nids, start=1):
            pos = bytearray()
            _write_field(pos, 1, 0, nid)
            mapping = bytearray()
            _write_field(mapping, 1, 2, bytes(pos))
            _write_field(mapping, 5, 0, rank)
            _write_field(pmsg, 2, 2, bytes(mapping))
        _write_field(out, 3, 2, bytes(pmsg))
    return bytes(out)


def write_vg(path: str, messages: List[bytes]) -> None:
    """Write messages as a gzip vg stream (one chunk)."""
    body = bytearray()
    _write_varint(body, len(messages))
    for msg in messages:
        _write_varint(body, len(msg))
        body.extend(msg)
    with gzip.open(path, "wb") as fh:
        fh.write(bytes(body))


def encode_vg_path_mappings(mappings) -> bytes:
    """Serialize a vg::Path message from
    [(node_id, offset, rank, [(from_len, to_len, seq)])] rows
    (the convert() output shape, ref: path_interface.hpp:842-942).
    Rows may carry a 5th element is_reverse (strand-aware exports from
    node-doubled bidirected graphs; ref: vg/vg.proto:29-34)."""
    pmsg = bytearray()
    for row in mappings:
        nid, off, rank, edits = row[0], row[1], row[2], row[3]
        is_rev = row[4] if len(row) > 4 else False
        pos = bytearray()
        _write_field(pos, 1, 0, nid)
        if off:
            _write_field(pos, 2, 0, off)
        if is_rev:
            _write_field(pos, 4, 0, 1)
        mapping = bytearray()
        _write_field(mapping, 1, 2, bytes(pos))
        for from_len, to_len, seq in edits:
            edit = bytearray()
            if from_len:
                _write_field(edit, 1, 0, from_len)
            if to_len:
                _write_field(edit, 2, 0, to_len)
            if seq:
                _write_field(edit, 3, 2, seq.encode("ascii"))
            _write_field(mapping, 2, 2, bytes(edit))
        _write_field(mapping, 5, 0, rank)
        _write_field(pmsg, 2, 2, bytes(mapping))
    return bytes(pmsg)


def encode_vg_alignment(
    name: str,
    sequence: str,
    path_nodes: List[Tuple[int, int]] = (),
    score: int = 0,
    identity: float = 0.0,
    mappings=None,
) -> bytes:
    """Serialize one vg::Alignment (GAM record): name, sequence, and a
    Path of (node_id, offset[, is_reverse]) mappings — or full
    mappings-with-edits rows via `mappings` (convert() shape)."""
    import struct as _struct

    out = bytearray()
    _write_field(out, 1, 2, sequence.encode("ascii"))
    if mappings is not None:
        _write_field(out, 2, 2, encode_vg_path_mappings(mappings))
    elif path_nodes:
        pmsg = bytearray()
        for rank, node in enumerate(path_nodes, start=1):
            nid, off = node[0], node[1]
            is_rev = node[2] if len(node) > 2 else False
            pos = bytearray()
            _write_field(pos, 1, 0, nid)
            if off:
                _write_field(pos, 2, 0, off)
            if is_rev:
                _write_field(pos, 4, 0, 1)
            mapping = bytearray()
            _write_field(mapping, 1, 2, bytes(pos))
            _write_field(mapping, 5, 0, rank)
            _write_field(pmsg, 2, 2, bytes(mapping))
        _write_field(out, 2, 2, bytes(pmsg))
    _write_field(out, 3, 2, name.encode("utf-8"))
    if score:
        _write_field(out, 6, 0, score)
    if identity:
        _write_varint(out, (16 << 3) | 1)  # field 16, 64-bit
        out.extend(_struct.pack("<d", identity))
    return bytes(out)


def write_gam(path: str, alignments: List[bytes], tagged: bool = True) -> None:
    """Write alignments as a gzip GAM stream (type-tagged framing)."""
    body = bytearray()
    if tagged:
        _write_varint(body, len(alignments) + 1)
        _write_varint(body, 3)
        body.extend(b"GAM")
    else:
        _write_varint(body, len(alignments))
    for msg in alignments:
        _write_varint(body, len(msg))
        body.extend(msg)
    with gzip.open(path, "wb") as fh:
        fh.write(bytes(body))


def read_gam(path: str) -> List[dict]:
    """Parse a GAM stream into dicts with name/sequence/path; path
    entries are (node_id, offset, is_reverse)."""
    out = []
    for msg in iter_vg_messages(path):
        rec = {"name": "", "sequence": "", "path": []}
        for field, wtype, val in _iter_fields(msg):
            if field == 1 and wtype == 2:
                rec["sequence"] = bytes(val).decode("ascii", "replace")
            elif field == 3 and wtype == 2:
                rec["name"] = bytes(val).decode("utf-8", "replace")
            elif field == 2 and wtype == 2:
                for f2, _, v2 in _iter_fields(val):
                    if f2 == 2:  # mapping
                        nid, off, rev = 0, 0, False
                        for f3, _, v3 in _iter_fields(v2):
                            if f3 == 1:  # position
                                for f4, _, v4 in _iter_fields(v3):
                                    if f4 == 1:
                                        nid = v4
                                    elif f4 == 2:
                                        off = v4
                                    elif f4 == 4:  # is_reverse
                                        rev = bool(v4)
                        rec["path"].append((nid, off, rev))
        out.append(rec)
    return out
