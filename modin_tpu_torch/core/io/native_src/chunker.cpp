// Newline/quote-aware CSV byte-range chunker.
//
// Native implementation of the reference's driver-side hot loop
// (modin/core/io/text/text_file_dispatcher.py:207 partitioned_file /
// :422 compute_newline): given a buffer, find the first record boundary at or
// after each requested offset, honoring quoted fields (a newline inside an
// open quote is not a record boundary).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstddef>

extern "C" {

// Scan [start, end) and return the offset of the first byte AFTER the first
// unquoted newline at or after `start`, assuming the quote parity at `start`
// is `in_quotes_at_start`.  Returns `end` if no boundary found.
int64_t next_record_boundary(
    const char* buf,
    int64_t start,
    int64_t end,
    char quotechar,
    int32_t in_quotes_at_start
) {
    bool in_quotes = in_quotes_at_start != 0;
    for (int64_t i = start; i < end; ++i) {
        char c = buf[i];
        if (c == quotechar) {
            in_quotes = !in_quotes;
        } else if (c == '\n' && !in_quotes) {
            return i + 1;
        }
    }
    return end;
}

// Count quote characters in [start, end) — used to carry quote parity across
// sequentially processed blocks.
int64_t count_quotes(const char* buf, int64_t start, int64_t end, char quotechar) {
    int64_t n = 0;
    for (int64_t i = start; i < end; ++i) {
        if (buf[i] == quotechar) {
            ++n;
        }
    }
    return n;
}

// Split [header_end, size) into up to `max_chunks` record-aligned byte ranges
// of roughly `target` bytes each.  Writes (start, end) pairs into `out`
// (caller-allocated, 2*max_chunks int64s).  Returns the number of chunks.
//
// Quote handling matches the reference's partitioned_file: boundaries are
// only accepted at unquoted newlines, with quote parity tracked from the
// start of the scan.
int64_t split_record_ranges(
    const char* buf,
    int64_t header_end,
    int64_t size,
    int64_t target,
    char quotechar,
    int64_t max_chunks,
    int64_t* out
) {
    int64_t n_chunks = 0;
    int64_t pos = header_end;
    bool in_quotes = false;
    int64_t scan_from = header_end;
    while (pos < size && n_chunks < max_chunks) {
        int64_t want = pos + target;
        if (want >= size) {
            out[2 * n_chunks] = pos;
            out[2 * n_chunks + 1] = size;
            ++n_chunks;
            break;
        }
        // carry quote parity from scan_from up to `want`
        for (int64_t i = scan_from; i < want; ++i) {
            if (buf[i] == quotechar) {
                in_quotes = !in_quotes;
            }
        }
        scan_from = want;
        // find the next unquoted newline at/after `want`
        int64_t boundary = want;
        bool iq = in_quotes;
        for (; boundary < size; ++boundary) {
            char c = buf[boundary];
            if (c == quotechar) {
                iq = !iq;
            } else if (c == '\n' && !iq) {
                ++boundary;
                break;
            }
        }
        // update parity for the region consumed beyond `want`
        for (int64_t i = scan_from; i < boundary; ++i) {
            if (buf[i] == quotechar) {
                in_quotes = !in_quotes;
            }
        }
        scan_from = boundary;
        out[2 * n_chunks] = pos;
        out[2 * n_chunks + 1] = boundary;
        ++n_chunks;
        pos = boundary;
    }
    return n_chunks;
}

}  // extern "C"
