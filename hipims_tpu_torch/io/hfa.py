"""Minimal Erdas Imagine (HFA / .img) raster reader and writer.

Implements the subset of the HFA format needed to read single-band DEM
rasters like the reference's bundled Newcastle model
(test/newcastle-centre/topography/NewcastleCentreDEM_2m.img): the
Ehfa_HeaderTag/Ehfa_File header, the Ehfa_Entry tree, Eimg_Layer geometry,
Edms_State block tables with both uncompressed and ESRI RLC-compressed
blocks, and Eprj_MapInfo georeferencing.  Written from scratch against the
published container layout; the reference reads these files through GDAL
(src/Datasets/CRasterDataset.cpp:73-96).

A copy of hipims_tpu/io/hfa.py: both write the same bytes and read each
other's files (tests/test_torch_io_extras.py).

Format notes (validated against real files):
  * all header/entry/table scalars little-endian;
  * entry tree: next/prev/parent/child/data pointers + name[64]/type[32];
  * Eimg_Layer: width, height, layerType(e16), pixelType(e16), blockWidth,
    blockHeight;
  * Edms_State: block table of (fileCode s16, offset i32, size i32,
    logvalid e16, compression e16);
  * RLC block: 13-byte header {min u32 LE, numRuns i32 LE, dataOffset i32
    LE, numBits u8}, then run counts (big-endian varints, 2-bit length tag
    in the top bits), then run values (big-endian, numBits each); pixel =
    min + value as integer arithmetic, reinterpreted for float types;
  * MapInfo coordinates are cell centres.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .raster import Raster

_PIXEL_TYPES = {
    3: np.dtype("u1"), 4: np.dtype("i1"),
    5: np.dtype("<u2"), 6: np.dtype("<i2"),
    7: np.dtype("<u4"), 8: np.dtype("<i4"),
    9: np.dtype("<f4"), 10: np.dtype("<f8"),
}


class _Entry:
    __slots__ = ("name", "type", "data", "data_size", "children")

    def __init__(self, name, typ, data, data_size):
        self.name = name
        self.type = typ
        self.data = data
        self.data_size = data_size
        self.children = []

    def find(self, typ=None, name=None):
        """Depth-first search."""
        stack = list(self.children)
        while stack:
            e = stack.pop(0)
            if (typ is None or e.type == typ) and \
               (name is None or e.name == name):
                return e
            stack.extend(e.children)
        return None


def _read_entries(buf, off):
    entries = []
    while off:
        nxt, _prev, _par, child, data, dsize = struct.unpack(
            "<IIIIIi", buf[off:off + 24])
        name = buf[off + 24:off + 88].split(b"\0")[0].decode("latin1")
        typ = buf[off + 88:off + 120].split(b"\0")[0].decode("latin1")
        e = _Entry(name, typ, data, dsize)
        if child:
            e.children = _read_entries(buf, child)
        entries.append(e)
        off = nxt
    return entries


def _decode_rlc(block: bytes, dtype: np.dtype, count: int) -> np.ndarray:
    """ESRI RLC decompression of one block (native codec when available,
    numpy/Python fallback otherwise)."""
    from ..native import decode_rlc_native
    native = decode_rlc_native(block, count)
    if native is not None:
        nbits = block[12]
        return _reinterpret(native.astype(np.uint64), dtype, nbits)[:count]

    dmin, nruns, doff = struct.unpack("<Iii", block[:12])
    nbits = block[12]

    if nruns == -1:
        # No run-length encoding; values bit-packed straight after header.
        raw = _unpack_values(block, 13, nbits, count)
        vals = (dmin + raw).astype(np.uint64)
        return _reinterpret(vals, dtype, nbits)[:count]

    counts = np.zeros(nruns, dtype=np.int64)
    p = 13
    mv = memoryview(block)
    for i in range(nruns):
        b0 = mv[p]
        tag = b0 >> 6
        if tag == 0:
            counts[i] = b0 & 0x3F
            p += 1
        elif tag == 1:
            counts[i] = ((b0 & 0x3F) << 8) | mv[p + 1]
            p += 2
        elif tag == 2:
            counts[i] = ((b0 & 0x3F) << 16) | (mv[p + 1] << 8) | mv[p + 2]
            p += 3
        else:
            counts[i] = (((b0 & 0x3F) << 24) | (mv[p + 1] << 16)
                         | (mv[p + 2] << 8) | mv[p + 3])
            p += 4

    raw = _unpack_values(block, doff, nbits, nruns)
    vals = (dmin + raw).astype(np.uint64)
    out = np.repeat(vals, counts)
    return _reinterpret(out, dtype, nbits)[:count]


def _unpack_values(block, offset, nbits, n):
    if nbits == 32:
        return np.frombuffer(block, dtype=">u4", count=n,
                             offset=offset).astype(np.uint64)
    if nbits == 16:
        return np.frombuffer(block, dtype=">u2", count=n,
                             offset=offset).astype(np.uint64)
    if nbits == 8:
        return np.frombuffer(block, dtype="u1", count=n,
                             offset=offset).astype(np.uint64)
    if nbits in (1, 2, 4):
        per_byte = 8 // nbits
        nbytes = -(-n // per_byte)
        bytes_ = np.frombuffer(block, dtype="u1", count=nbytes, offset=offset)
        shifts = np.arange(per_byte, dtype=np.uint8) * nbits
        mask = (1 << nbits) - 1
        vals = ((bytes_[:, None] >> shifts[None, :]) & mask).reshape(-1)
        return vals[:n].astype(np.uint64)
    if nbits == 0:
        return np.zeros(n, dtype=np.uint64)
    raise ValueError(f"unsupported RLC bit width {nbits}")


def _reinterpret(vals: np.ndarray, dtype: np.dtype, nbits) -> np.ndarray:
    """Integer min+delta result -> target pixel dtype (float types are
    reinterpretations of the raw 32/64-bit patterns)."""
    if dtype == np.dtype("<f4"):
        return vals.astype(np.uint32).view(np.float32)
    if dtype == np.dtype("<f8"):
        return vals.view(np.float64)
    return vals.astype(dtype)


def read_hfa(path) -> Raster:
    buf = Path(path).read_bytes()
    if not buf.startswith(b"EHFA_HEADER_TAG"):
        raise ValueError(f"{path}: not an HFA file")
    (hdr_ptr,) = struct.unpack("<I", buf[16:20])
    _ver, _free, root_ptr, _ehl, _dict_ptr = struct.unpack(
        "<IIIhI", buf[hdr_ptr:hdr_ptr + 18])
    root = _Entry("root", "root", 0, 0)
    root.children = _read_entries(buf, root_ptr)

    layer = root.find(typ="Eimg_Layer")
    if layer is None:
        raise ValueError(f"{path}: no Eimg_Layer")
    width, height, _lt, pixel_type, bw, bh = struct.unpack(
        "<iiHHii", buf[layer.data:layer.data + 20])
    if pixel_type not in _PIXEL_TYPES:
        raise ValueError(f"{path}: unsupported pixel type {pixel_type}")
    dtype = _PIXEL_TYPES[pixel_type]

    dms = layer.find(typ="Edms_State")
    if dms is None:
        raise ValueError(f"{path}: no Edms_State block table "
                         "(external/spill files not supported)")
    o = dms.data
    _nvb, _nopb, _nextobj = struct.unpack("<iii", buf[o:o + 12])
    o += 12
    o += 2  # compressionType enum
    (n_blocks, _ptr) = struct.unpack("<II", buf[o:o + 8])
    o += 8
    blocks = []
    for _ in range(n_blocks):
        _fc, off, size, logvalid, comp = struct.unpack(
            "<hiiHH", buf[o:o + 14])
        o += 14
        blocks.append((off, size, logvalid, comp))

    blocks_x = -(-width // bw)
    data = np.zeros((-(-height // bh) * bh, blocks_x * bw), dtype=dtype)
    per_block = bw * bh
    for idx, (off, size, logvalid, comp) in enumerate(blocks):
        by, bx = divmod(idx, blocks_x)
        if not logvalid:
            tile = np.zeros(per_block, dtype=dtype)
        elif comp == 0:
            tile = np.frombuffer(buf, dtype=dtype, count=per_block,
                                 offset=off)
        else:
            tile = _decode_rlc(buf[off:off + size], dtype, per_block)
        data[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw] = \
            tile.reshape(bh, bw)
    data = np.ascontiguousarray(data[:height, :width])

    # Georeferencing: Eprj_MapInfo {pc proName, *o upperLeftCenter,
    # *o lowerRightCenter, *o pixelSize, pc units} — pointers are 8-byte
    # (count, offset) headers with the payload inline.
    xll = yll = 0.0
    cell = 1.0
    mi = root.find(typ="Eprj_MapInfo")
    if mi is not None:
        p = mi.data
        cnt, _off = struct.unpack("<II", buf[p:p + 8])
        p += 8 + cnt                       # proName chars
        p += 8
        ulx, uly = struct.unpack("<dd", buf[p:p + 16])
        p += 16
        p += 8
        _lrx, lry = struct.unpack("<dd", buf[p:p + 16])
        p += 16
        p += 8
        csx, _csy = struct.unpack("<dd", buf[p:p + 16])
        p += 16
        cell = csx
        # Centres -> lower-left corner of the grid.
        xll = ulx - cell / 2.0
        yll = lry - cell / 2.0

    # Nodata: Eimg_NonInitializedValue {*b valueBD} = 8-byte pointer +
    # BASEDATA {i32 nrows, i32 ncols, i16 datatype, i16 objecttype, data}.
    nodata = None
    niv = root.find(typ="Eimg_NonInitializedValue")
    if niv is not None:
        p = niv.data + 8
        nrows, ncols, dt_code = struct.unpack("<iih", buf[p:p + 10])
        p += 12
        if nrows * ncols >= 1:
            if dt_code == 9:
                nodata = float(np.frombuffer(buf, "<f4", 1, p)[0])
            elif dt_code == 10:
                nodata = float(np.frombuffer(buf, "<f8", 1, p)[0])
    if nodata is None:
        nodata = -9999.0

    return Raster(data=data, xll=xll, yll=yll, cell_size=cell,
                  nodata=nodata)


# ---------------------------------------------------------------- write ----

# MIF data dictionary covering exactly the node types we emit, in the
# published dictionary syntax (so standard readers can interpret the file).
_DICTIONARY = (
    "{1:lwidth,1:lheight,1:e3:thematic,athematic,fft of real-valued data,"
    "layerType,1:e13:u1,u2,u4,u8,s8,u16,s16,u32,s32,f32,f64,c64,c128,"
    "pixelType,1:lblockWidth,1:lblockHeight,}Eimg_Layer,"
    "{1:lnumvirtualblocks,1:lnumobjectsperblock,1:lnextobjectnum,"
    "1:e2:no compression,ESRI GRID compression,compressionType,"
    "0:poEdms_VirtualBlockInfo,blockinfo,0:poEdms_FreeIDList,freelist,"
    "1:tmodTime,}Edms_State,"
    "{1:SfileCode,1:Loffset,1:Lsize,1:e2:false,true,logvalid,"
    "1:e2:no compression,RLC compression,compressiontype,}"
    "Edms_VirtualBlockInfo,"
    "{1:Lmin,1:Lmax,}Edms_FreeIDList,"
    "{0:pcproName,1:*oEprj_Coordinate,upperLeftCenter,"
    "1:*oEprj_Coordinate,lowerRightCenter,1:*oEprj_Size,pixelSize,"
    "0:pcunits,}Eprj_MapInfo,"
    "{1:dx,1:dy,}Eprj_Coordinate,"
    "{1:dwidth,1:dheight,}Eprj_Size,"
    "{1:*bvalueBD,}Eimg_NonInitializedValue,"
    "."
)

_ENTRY_LEN = 128


def _entry_bytes(nxt, prev, parent, child, data, dsize, name, typ):
    raw = struct.pack("<IIIIIi", nxt, prev, parent, child, data, dsize)
    raw += name.encode("latin1").ljust(64, b"\0")
    raw += typ.encode("latin1").ljust(32, b"\0")
    raw += struct.pack("<I", 0)                   # modTime
    return raw.ljust(_ENTRY_LEN, b"\0")


def write_hfa(path, raster: Raster):
    """Write a single-band HFA (.img) file: uncompressed 64x64 blocks,
    Eprj_MapInfo georeferencing and an Eimg_NonInitializedValue nodata
    marker — the same node set ``read_hfa`` consumes (round-trip tested),
    laid out per the published HFA container spec.  The reference emits
    these through GDAL's HFA driver (src/Datasets/CRasterDataset.cpp)."""
    data = np.asarray(raster.data)
    if data.dtype == np.float64:
        dtype, ptype, dt_code = np.dtype("<f8"), 10, 10
    else:
        data = data.astype(np.float32)
        dtype, ptype, dt_code = np.dtype("<f4"), 9, 9
    height, width = data.shape
    bw = bh = 64
    blocks_x = -(-width // bw)
    blocks_y = -(-height // bh)
    n_blocks = blocks_x * blocks_y
    block_bytes = bw * bh * dtype.itemsize

    nodata = raster.nodata if raster.nodata is not None else -9999.0
    padded = np.full((blocks_y * bh, blocks_x * bw), nodata, dtype=dtype)
    padded[:height, :width] = data

    # ---- fixed-position plan ------------------------------------------
    # [0:20)   header tag + ptr
    # [20:40)  Ehfa_File
    # entries: root, Layer_1, RasterDMS, Map_Info, NoDataValue
    pos = 40
    e_root = pos
    e_layer = e_root + _ENTRY_LEN
    e_dms = e_layer + _ENTRY_LEN
    e_map = e_dms + _ENTRY_LEN
    e_niv = e_map + _ENTRY_LEN
    pos = e_niv + _ENTRY_LEN

    d_layer = pos
    layer_data = struct.pack("<iiHHii", width, height, 1, ptype, bw, bh)
    pos += len(layer_data)

    d_dms = pos
    dms_head = struct.pack("<iiiH", n_blocks, bw * bh, n_blocks + 1, 0)
    # 'p' pointer: count + file offset of the records (inline, next byte).
    blockinfo_hdr_at = d_dms + len(dms_head)
    records_at = blockinfo_hdr_at + 8
    rec_len = 14
    freelist_at = records_at + n_blocks * rec_len
    dms_tail_len = 8 + 4                              # freelist ptr + modTime
    pos = freelist_at + dms_tail_len

    d_map = pos
    proname = b"Generic Binary\0"
    units = b"meters\0"
    cell = raster.cell_size
    ulx = raster.xll + cell / 2.0
    uly = raster.yll + (height - 0.5) * cell
    lrx = raster.xll + (width - 0.5) * cell
    lry = raster.yll + cell / 2.0

    map_parts = []
    p = d_map
    map_parts.append(struct.pack("<II", len(proname), p + 8))
    map_parts.append(proname)
    p += 8 + len(proname)
    map_parts.append(struct.pack("<II", 1, p + 8))
    map_parts.append(struct.pack("<dd", ulx, uly))
    p += 8 + 16
    map_parts.append(struct.pack("<II", 1, p + 8))
    map_parts.append(struct.pack("<dd", lrx, lry))
    p += 8 + 16
    map_parts.append(struct.pack("<II", 1, p + 8))
    map_parts.append(struct.pack("<dd", cell, cell))
    p += 8 + 16
    map_parts.append(struct.pack("<II", len(units), p + 8))
    map_parts.append(units)
    p += 8 + len(units)
    map_data = b"".join(map_parts)
    pos = d_map + len(map_data)

    d_niv = pos
    niv_data = (struct.pack("<II", 1, d_niv + 8)
                + struct.pack("<iihh", 1, 1, dt_code, 0)
                + np.asarray([nodata], dtype=dtype).tobytes())
    pos = d_niv + len(niv_data)

    # Block data, 16-byte aligned.
    pos = (pos + 15) & ~15
    d_blocks = pos
    pos += n_blocks * block_bytes
    d_dict = pos

    # ---- assemble -------------------------------------------------------
    out = bytearray()
    out += b"EHFA_HEADER_TAG\0" + struct.pack("<I", 20)
    out += struct.pack("<IIIhI", 1, 0, e_root, _ENTRY_LEN, d_dict)
    out += b"\0" * (40 - len(out))

    out += _entry_bytes(0, 0, 0, e_layer, 0, 0, "root", "root")
    out += _entry_bytes(e_map, 0, e_root, e_dms, d_layer, len(layer_data),
                        "Layer_1", "Eimg_Layer")
    out += _entry_bytes(e_niv, 0, e_layer, 0, d_dms,
                        freelist_at + dms_tail_len - d_dms,
                        "RasterDMS", "Edms_State")
    out += _entry_bytes(0, e_layer, e_root, 0, d_map, len(map_data),
                        "Map_Info", "Eprj_MapInfo")
    out += _entry_bytes(0, 0, e_layer, 0, d_niv, len(niv_data),
                        "NoDataValue", "Eimg_NonInitializedValue")

    out += layer_data
    out += dms_head
    out += struct.pack("<II", n_blocks, records_at)
    for b in range(n_blocks):
        out += struct.pack("<hiiHH", 0, d_blocks + b * block_bytes,
                           block_bytes, 1, 0)
    out += struct.pack("<II", 0, 0) + struct.pack("<I", 0)
    out += map_data
    out += niv_data
    out += b"\0" * (d_blocks - len(out))

    for by in range(blocks_y):
        for bx in range(blocks_x):
            tile = padded[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw]
            out += np.ascontiguousarray(tile).tobytes()

    out += _DICTIONARY.encode("latin1") + b"\0"
    Path(path).write_bytes(bytes(out))
