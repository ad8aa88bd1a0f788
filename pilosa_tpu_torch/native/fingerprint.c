/* Query fingerprint scanner: the C hot path behind
 * pilosa_tpu_torch/executor/prepared.py's fingerprint() (copied from the
 * JAX package's native/fingerprint.c).
 *
 * Replaces every bare integer literal in a PQL text with '?' and collects
 * the literal values, exactly like the _FP regex (prepared.py): a literal
 * is an optional '-' followed by digits, where the characters on both
 * sides are outside [A-Za-z0-9_.:-] (so digits inside identifiers,
 * floats, timestamps like 2017-01-01T00:00, and key:ranges never match),
 * and single-/double-quoted strings (with backslash escapes) are opaque.
 *
 * The fingerprint gate runs in front of the prepared-statement cache on
 * every request, where a Python regex pass holds the interpreter lock for
 * every call of the text; this scanner runs the same pass at memory speed.
 *
 * Returns the number of literals found (>= 0), writing the template text
 * to *tmpl (always <= n bytes) and the values to vals.  Returns -1 when a
 * literal cannot be represented (digit run longer than 18 chars could
 * overflow int64); the caller falls back to the Python path, which has
 * arbitrary-precision ints.
 */

#include <stdint.h>

/* [A-Za-z0-9_.:-] — the regex's \w plus .:- */
static inline int boundary_class(unsigned char c) {
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') ||
           (c >= '0' && c <= '9') || c == '_' || c == '.' || c == ':' ||
           c == '-';
}

static inline int is_digit(unsigned char c) { return c >= '0' && c <= '9'; }

long fingerprint_scan(const unsigned char *src, long n, unsigned char *tmpl,
                      long *tmpl_len, int64_t *vals, long max_vals) {
    long i = 0, o = 0, nv = 0;
    /* prev: the byte before the current scan position ('\0' at start —
     * not in the class, matching the regex's lookbehind at offset 0). */
    unsigned char prev = 0;
    while (i < n) {
        unsigned char c = src[i];
        if (c == '\'' || c == '"') {
            /* try to consume a quoted string; on no closing quote the
             * quote is an ordinary character (the regex alternation would
             * fail the same way and move on one char) */
            long j = i + 1;
            while (j < n && src[j] != c) {
                if (src[j] == '\\' && j + 1 < n)
                    j++; /* escaped char */
                j++;
            }
            if (j < n) { /* closed: copy verbatim, contents are opaque */
                for (long k = i; k <= j; k++)
                    tmpl[o++] = src[k];
                prev = c;
                i = j + 1;
                continue;
            }
            tmpl[o++] = c;
            prev = c;
            i++;
            continue;
        }
        if ((is_digit(c) || (c == '-' && i + 1 < n && is_digit(src[i + 1])))
            && !boundary_class(prev)) {
            long j = i, start;
            int neg = 0;
            if (src[j] == '-') {
                neg = 1;
                j++;
            }
            start = j;
            while (j < n && is_digit(src[j]))
                j++;
            if (j < n && boundary_class(src[j])) {
                /* trailing boundary fails (identifier/float/timestamp):
                 * the whole run is ordinary text */
                for (long k = i; k < j; k++)
                    tmpl[o++] = src[k];
                prev = src[j - 1];
                i = j;
                continue;
            }
            if (j - start > 18)
                return -1; /* may overflow int64: Python path */
            {
                int64_t v = 0;
                for (long k = start; k < j; k++)
                    v = v * 10 + (src[k] - '0');
                if (nv >= max_vals)
                    return -1;
                vals[nv++] = neg ? -v : v;
            }
            tmpl[o++] = '?';
            prev = src[j - 1];
            i = j;
            continue;
        }
        tmpl[o++] = c;
        prev = c;
        i++;
    }
    *tmpl_len = o;
    return nv;
}
