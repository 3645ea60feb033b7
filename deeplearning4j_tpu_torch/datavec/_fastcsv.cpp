// Native numeric-CSV parser: the ETL hot loop (DataVec analog's fast path).
//
// The reference's ETL ran record parsing inside the JVM (DataVec
// CSVRecordReader); this framework's equivalent hot loop is C++ reached via
// ctypes (deeplearning4j_tpu/datavec/native.py), releasing the GIL for the
// whole parse. Strictly numeric rectangular CSV only — anything else
// returns a sentinel and the caller falls back to the Python path, which
// handles strings/ragged rows.

#include <cstdlib>
#include <cstring>

extern "C" {

// Scan dims of the body (after skip_lines): rows = non-empty lines,
// cols = field count of the first non-empty line. Returns 0, or -3 if any
// line has a different field count (ragged).
long csv_dims(const char* buf, long len, char delim, long skip_lines,
              long* n_rows, long* n_cols) {
    long rows = 0, cols = 0;
    long line_start = 0;
    long skipped = 0;
    for (long i = 0; i <= len; ++i) {
        if (i == len || buf[i] == '\n') {
            long end = i;
            if (end > line_start && buf[end - 1] == '\r') --end;
            if (end > line_start) {  // non-empty line
                if (skipped < skip_lines) {
                    ++skipped;
                } else {
                    long c = 1;
                    for (long j = line_start; j < end; ++j)
                        if (buf[j] == delim) ++c;
                    if (cols == 0) cols = c;
                    else if (c != cols) return -3;
                    ++rows;
                }
            } else if (skipped < skip_lines && i < len) {
                ++skipped;  // empty line still counts toward the skip
            }
            line_start = i + 1;
        }
    }
    *n_rows = rows;
    *n_cols = cols;
    return 0;
}

// Field sanity: Python float() semantics, conservatively. Only plain
// decimal/scientific notation is accepted — no hex (strtod would parse
// "0x1A"), no locale decimal commas, no embedded NULs, no alphabetic
// spellings (nan/inf decline to the Python path, which parses them the
// same way float() does).
static bool field_chars_ok(const char* p, long n) {
    for (long i = 0; i < n; ++i) {
        char ch = p[i];
        if (!((ch >= '0' && ch <= '9') || ch == '+' || ch == '-'
              || ch == '.' || ch == 'e' || ch == 'E'
              || ch == ' ' || ch == '\t'))
            return false;
    }
    return true;
}

// Parse into out[rows*cols] (row-major), with rows/cols as produced by a
// prior csv_dims call (no second dimension scan). Returns rows parsed
// (>= 0), or -1 if a field is not a plain finite number (caller falls back
// to Python), -2 if capacity is too small, -3 if a line disagrees with
// cols.
long csv_parse_numeric(const char* buf, long len, char delim, long skip_lines,
                       long rows, long cols,
                       double* out, long capacity) {
    if (rows * cols > capacity) return -2;

    long r = 0, skipped = 0;
    long line_start = 0;
    for (long i = 0; i <= len && r < rows; ++i) {
        if (i == len || buf[i] == '\n') {
            long end = i;
            if (end > line_start && buf[end - 1] == '\r') --end;
            if (end > line_start) {
                if (skipped < skip_lines) {
                    ++skipped;
                } else {
                    const char* p = buf + line_start;
                    const char* line_end = buf + end;
                    for (long c = 0; c < cols; ++c) {
                        if (p > line_end) return -3;
                        const char* field_end = p;
                        while (field_end < line_end && *field_end != delim)
                            ++field_end;
                        // strtod needs a bounded, NUL-terminated view
                        char tmp[64];
                        long flen = field_end - p;
                        if (flen <= 0 || flen >= (long)sizeof(tmp)) return -1;
                        if (!field_chars_ok(p, flen)) return -1;
                        memcpy(tmp, p, flen);
                        tmp[flen] = '\0';
                        char* parse_end = nullptr;
                        double v = strtod(tmp, &parse_end);
                        while (parse_end && (*parse_end == ' '
                                             || *parse_end == '\t'))
                            ++parse_end;
                        if (parse_end == tmp || *parse_end != '\0') return -1;
                        out[r * cols + c] = v;
                        p = field_end + 1;
                    }
                    if (p <= line_end) return -3;  // extra fields on line
                    ++r;
                }
            } else if (skipped < skip_lines && i < len) {
                ++skipped;
            }
            line_start = i + 1;
        }
    }
    return r;
}

}  // extern "C"
