// Copied from khoice_tpu/native/fasta_codec.cpp.
// Native FASTA scanner for the host IO layer.
//
// The reference delegates FASTA parsing to native tools (KMC3 reads
// multi-FASTA directly, reference workflow/rules/exp_type_1.smk:163;
// seqtk handles format transforms, prepare_data.smk:85). This gives the
// rebuild's Python IO layer (khoice_tpu/io/fasta.py) the same native-speed
// ingest: one pass over the decompressed bytes producing either uppercased
// sequence bytes or 2-bit+invalid codes (A=0 C=1 G=2 T=3, other=4 — the
// engine's encoding, khoice_tpu/io/packing.py) plus per-record name/seq
// bounds. Bound via ctypes (no pybind11 in the image).
//
// The port's copy differs in three respects: fasta_max_records bounds the
// record count without a pass in Python, fasta_scan can write a separator
// byte between records (the records' codes joined as the port's
// io/packing.encode_records joins them, with no copy after the scan), and
// sequence bytes before the first header are skipped, not written. Both
// run without the interpreter lock (ctypes releases it), so a pool of
// threads scans files side by side.
//
// Build: g++ -O3 -shared -fPIC fasta_codec.cpp -o libkhoice_fasta.so

#include <cstdint>
#include <cstring>

namespace {

struct Luts {
    uint8_t code[256];
    uint8_t upper[256];
    Luts() {
        for (int i = 0; i < 256; i++) {
            code[i] = 4;
            upper[i] = static_cast<uint8_t>(i);
        }
        const char* b = "ACGT";
        for (int i = 0; i < 4; i++) {
            code[static_cast<uint8_t>(b[i])] = static_cast<uint8_t>(i);
            code[static_cast<uint8_t>(b[i] + 32)] = static_cast<uint8_t>(i);
        }
        for (int c = 'a'; c <= 'z'; c++) {
            upper[c] = static_cast<uint8_t>(c - 32);
        }
    }
};
const Luts LUTS;

}  // namespace

// A bound on the records fasta_scan finds in data[0, n): one more than
// the number of '>' bytes, as its max_recs.
extern "C" int64_t fasta_max_records(const uint8_t* data, int64_t n) {
    int64_t count = 1;
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    while (p < end) {
        p = static_cast<const uint8_t*>(memchr(p, '>', static_cast<size_t>(end - p)));
        if (!p) break;
        count++;
        p++;
    }
    return count;
}

// Scan FASTA text. data/n: decompressed file bytes. seq_out: caller buffer
// of >= n bytes receiving concatenated record sequences (uppercased bytes,
// or engine codes when to_codes != 0), with the byte sep written between
// two records' sequences when sep >= 0 (each record's '>' leaves room for
// it). rec: caller buffer of 4*max_recs int64s; record r gets
// {name_start, name_end} (byte offsets into data; the name is the header
// token up to the first whitespace, matching the Python reader's
// `line[1:].split()[0]`) and {seq_start, seq_end} (offsets into seq_out;
// a separator lies outside both records' bounds). Sequence bytes before
// the first header are dropped, like the Python reader. Returns the record
// count, or -1 if it exceeds max_recs.
extern "C" int64_t fasta_scan(const uint8_t* data, int64_t n,
                              uint8_t* seq_out, int64_t* rec,
                              int64_t max_recs, int to_codes, int sep) {
    const uint8_t* lut = to_codes ? LUTS.code : LUTS.upper;
    int64_t nr = -1;  // current record index
    int64_t so = 0;   // seq_out write position
    // 0 = at line start, 1 = in header name, 2 = in header rest, 3 = in seq
    int state = 0;
    bool name_seen = false;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = data[i];
        if (state == 0) {
            if (c == '>') {
                if (nr + 1 >= max_recs) return -1;
                if (nr >= 0) {
                    rec[4 * nr + 3] = so;
                    if (sep >= 0) seq_out[so++] = static_cast<uint8_t>(sep);
                }
                nr++;
                rec[4 * nr + 0] = i + 1;
                rec[4 * nr + 1] = i + 1;
                rec[4 * nr + 2] = so;  // provisional; finalized at header end
                state = 1;
                name_seen = false;
                continue;
            }
            if (c == '\n' || c == '\r') continue;  // blank line
            state = 3;  // fall through to sequence handling
        }
        if (state == 1) {
            if (c == '\n') {
                rec[4 * nr + 1] = i;
                rec[4 * nr + 2] = so;
                state = 0;
            } else if (c == ' ' || c == '\t' || c == '\r') {
                if (!name_seen) {
                    // leading whitespace after '>' — the Python reader's
                    // split() skips it, so the name starts later
                    rec[4 * nr + 0] = i + 1;
                    rec[4 * nr + 1] = i + 1;
                } else {
                    rec[4 * nr + 1] = i;
                    state = 2;
                }
            } else {
                name_seen = true;
            }
            continue;
        }
        if (state == 2) {
            if (c == '\n') {
                rec[4 * nr + 2] = so;
                state = 0;
            }
            continue;
        }
        // state == 3: sequence line — bulk-translate to the next newline
        // (memchr + LUT loop lets the compiler vectorize; sequence bytes
        // dominate real FASTA, so this is the hot path)
        const uint8_t* nl = static_cast<const uint8_t*>(
            memchr(data + i, '\n', static_cast<size_t>(n - i)));
        int64_t end = nl ? (nl - data) : n;
        int64_t len = end - i;
        if (len > 0 && data[end - 1] == '\r') len--;
        if (nr < 0) len = 0;  // before the first header: no record's bytes
        for (int64_t j = 0; j < len; j++) {
            seq_out[so + j] = lut[data[i + j]];
        }
        so += len;
        i = end;  // loop increment moves past the newline
        state = 0;
    }
    if (nr >= 0) {
        if (state == 1) rec[4 * nr + 1] = n;
        if (state == 1 || state == 2) rec[4 * nr + 2] = so;
        rec[4 * nr + 3] = so;
    }
    return nr + 1;
}
