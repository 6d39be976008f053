/*
 * host_parse.c — the port's host parser library.
 *
 * It is native/kmer_native.c, included whole, so every function there
 * keeps its behaviour byte for byte, plus the port's own FASTA parses:
 *
 * - kb_fasta_encode_mt, the "skip" parse (non-ACGT bases dropped and
 *   their flanks joined), with output byte for byte that of
 *   kn_fasta_encode;
 * - kb_encode_break_mt, the parse that breaks windows at non-ACGT runs
 *   (`n_policy` "break", as jellyfish, meryl and KMC count): a maximal
 *   run of sequence bytes that CODE_LUT does not encode (N, n, IUPAC
 *   letters, anything else but a line end) ends the current contig, and
 *   the next base begins a new one with its own offset.  A run at a
 *   record's start or end begins nothing, so a record of bases and runs
 *   becomes one read per maximal ACGT run (a record with no base stays
 *   one empty read, as the skipping parsers give it).  Each contig's
 *   windows are then counted as they would be alone.  Each call also
 *   reports `breaks` (contigs begun at a run inside a record) and
 *   `gap_bytes` (the non-ACGT sequence bytes, which no window crosses).
 *
 * Both run kn_reads_encode_mt's two phases (count, then write at
 * prefix-summed bases) on threads that each take a range of the buffer.
 * A FASTA range starts at a record start where one lies in it; where
 * none does (a record longer than a range: a chromosome), it starts at a
 * line start inside the record where the one-thread parse's state is
 * known from the bytes around it (kb_line_start_ok), so one long record
 * is parsed by every thread.  Each call reports how its interior bounds
 * were taken: at a record start, at a line start, or merged (none found,
 * the range joins its neighbour).  FASTQ keeps kmer_native.c's record
 * split.
 *
 * Build: cc -O3 -shared -fPIC -pthread -o libkmer_native.so host_parse.c
 */

#include <string.h>

#include "../../native/kmer_native.c"

typedef struct {
    const char *buf;
    long long start, end;     /* byte range: a record or a line start */
    uint8_t *codes;           /* phase-2 outputs */
    long long *offsets;
    long long code_base, read_base;
    long long reads, bases;   /* phase-1 results */
    long long breaks, gap_bytes;
    long long err;            /* -1 ok, else global byte index of bad input */
    int write;                /* 0 = count, 1 = write */
    int mid;                  /* starts inside a record (a line split) */
    int skip_invalid;         /* "skip" parse: drop bad bytes, else stop */
} kb_job;

/* How an interior bound was taken; the index into a call's counts. */
enum { KB_SPLIT_RECORD, KB_SPLIT_LINE, KB_SPLIT_MERGED };

/* The first record start ('>' at a line start) in [pos, lim), or -1. */
static long long kb_record_start(const char *buf, long long pos,
                                 long long lim)
{
    const char *p = buf + pos, *e = buf + lim;
    while (p < e && (p = memchr(p, '>', (size_t)(e - p))) != NULL) {
        if (p[-1] == '\n')
            return p - buf;
        p++;
    }
    return -1;
}

/* Whether a range may start at line start b inside a record (b begins no
 * header: its range holds no record start): where the one-thread parse
 * has a read begun, because the line before b holds a byte other than
 * '\r'.  "break" (brk) also needs no gap pending: the last byte before b
 * (past '\r') is a base, of a contig or of a header that began one, and
 * so is b's first, which then extends the contig open at b, whatever its
 * length. */
static int kb_line_start_ok(const char *buf, long long b, int brk)
{
    long long p = b - 2;
    while (p >= 0 && buf[p] == '\r')
        p--;
    if (p < 0 || buf[p] == '\n')
        return 0;
    return !brk || (CODE_LUT[(uint8_t)buf[p]] != 0xFF &&
                    CODE_LUT[(uint8_t)buf[b]] != 0xFF);
}

/* The first line start at or after pos and below lim where a range may
 * start inside a record, or -1. */
static long long kb_line_split(const char *buf, long long pos, long long lim,
                               int brk)
{
    long long b = pos;
    while (b < lim) {
        if (buf[b - 1] == '\n' && kb_line_start_ok(buf, b, brk))
            return b;
        const char *q = memchr(buf + b, '\n', (size_t)(lim - b));
        if (q == NULL)
            return -1;
        b = q - buf + 1;
    }
    return -1;
}

/* Bounds of T FASTA ranges.  Interior bound t looks in range t,
 * [n*t/T, n*(t+1)/T): at its first record start, else at its first line
 * start that kb_line_split takes (mid[t] set), else nowhere, and then
 * takes bound t+1's place (bound T is n), so range t joins range t-1.
 * splits[kind] counts the interior bounds by kind. */
static void kb_fasta_bounds(const char *buf, long long n, int T, int brk,
                            long long *bounds, int *mid, long long *splits)
{
    int t;
    bounds[0] = 0;
    mid[0] = 0;
    bounds[T] = n;
    mid[T] = 0;
    for (t = 1; t < T; t++) {
        long long pos = n * t / T, lim = n * (t + 1) / T;
        long long b = kb_record_start(buf, pos, lim);
        mid[t] = 0;
        if (b >= 0) {
            splits[KB_SPLIT_RECORD]++;
        } else if ((b = kb_line_split(buf, pos, lim, brk)) >= 0) {
            mid[t] = 1;
            splits[KB_SPLIT_LINE]++;
        } else {
            splits[KB_SPLIT_MERGED]++;
        }
        bounds[t] = b;
    }
    for (t = T - 1; t >= 1; t--)
        if (bounds[t] < 0) {
            bounds[t] = bounds[t + 1];
            mid[t] = mid[t + 1];
        }
}

/* kmer_native.c's record split, for FASTQ. */
static void kb_fastq_bounds(const char *buf, long long n, int T,
                            long long *bounds, int *mid)
{
    int t;
    bounds[0] = 0;
    for (t = 1; t < T; t++) {
        bounds[t] = fastq_boundary(buf, n, n * t / T);
        if (bounds[t] < bounds[t - 1])
            bounds[t] = bounds[t - 1];
    }
    bounds[T] = n;
    for (t = 0; t <= T; t++)
        mid[t] = 0;
}

/* kn_fasta_worker's parse, which a range at a line split starts with
 * its record's read already begun. */
static void *kb_fasta_skip_worker(void *arg)
{
    kb_job *j = (kb_job *)arg;
    const char *buf = j->buf;
    long long i = j->start, end = j->end, w = 0, r = 0;
    j->err = -1;
    while (i < end) {
        if (buf[i] == '>') {
            while (i < end && buf[i] != '\n')
                i++;
            i++;
            if (j->write)
                j->offsets[j->read_base + r] = j->code_base + w;
            r++;
            continue;
        }
        char ch = buf[i];
        if (ch == '\n' || ch == '\r') {
            i++;
            continue;
        }
        if (r == 0 && !j->mid) {  /* headerless leading data: range 0 */
            if (j->write)
                j->offsets[j->read_base] = j->code_base;
            r++;
        }
        uint8_t c = CODE_LUT[(uint8_t)ch];
        if (c == 0xFF) {
            if (!j->skip_invalid) {
                j->err = i;
                return NULL;
            }
        } else {
            if (j->write)
                j->codes[j->code_base + w] = c;
            w++;
        }
        i++;
    }
    j->reads = r;
    j->bases = w;
    j->breaks = j->gap_bytes = 0;
    return NULL;
}

/* The contig state of one worker: `open` is the bases of the current
 * contig, `gap` whether a non-ACGT byte followed them. */
typedef struct {
    long long w, r, open, breaks, gap_bytes;
    int gap;
} kb_state;

static inline void kb_begin(kb_job *j, kb_state *s)
{
    if (j->write)
        j->offsets[j->read_base + s->r] = j->code_base + s->w;
    s->r++;
    s->open = 0;
    s->gap = 0;
}

static inline void kb_byte(kb_job *j, kb_state *s, char ch)
{
    uint8_t c = CODE_LUT[(uint8_t)ch];
    if (c == 0xFF) {
        s->gap_bytes++;
        s->gap = s->open > 0;
        return;
    }
    if (s->gap) {               /* a run ended the contig: begin the next */
        kb_begin(j, s);
        s->breaks++;
    }
    if (j->write)
        j->codes[j->code_base + s->w] = c;
    s->w++;
    s->open++;
}

static void kb_done(kb_job *j, const kb_state *s)
{
    j->reads = s->r;
    j->bases = s->w;
    j->breaks = s->breaks;
    j->gap_bytes = s->gap_bytes;
}

static void *kb_fasta_worker(void *arg)
{
    kb_job *j = (kb_job *)arg;
    const char *buf = j->buf;
    long long i = j->start, end = j->end;
    kb_state s = {0, 0, 0, 0, 0, 0};
    j->err = -1;
    while (i < end) {
        char ch = buf[i];
        if (ch == '>') {
            while (i < end && buf[i] != '\n')
                i++;
            i++;
            kb_begin(j, &s);
            continue;
        }
        if (ch == '\n' || ch == '\r') {
            i++;
            continue;
        }
        /* headerless leading data (range 0); at a line split the first
         * base extends the contig open before the range */
        if (s.r == 0 && !j->mid)
            kb_begin(j, &s);
        kb_byte(j, &s, ch);
        i++;
    }
    kb_done(j, &s);
    return NULL;
}

static void *kb_fastq_worker(void *arg)
{
    kb_job *j = (kb_job *)arg;
    const char *buf = j->buf;
    long long i = j->start, end = j->end;
    kb_state s = {0, 0, 0, 0, 0, 0};
    j->err = -1;
    while (i < end) {
        if (buf[i] == '\n' || buf[i] == '\r') {
            i++;
            continue;
        }
        if (buf[i] != '@') {
            j->err = i;
            return NULL;
        }
        while (i < end && buf[i] != '\n')
            i++;
        i++;
        kb_begin(j, &s);
        long long seq_len = 0;
        while (i < end && buf[i] != '\n') {
            char ch = buf[i];
            if (ch != '\r') {
                kb_byte(j, &s, ch);
                seq_len++;
            }
            i++;
        }
        i++;
        if (i < end) {
            if (buf[i] != '+') {
                j->err = i;
                return NULL;
            }
            while (i < end && buf[i] != '\n')
                i++;
            i++;
        }
        long long q = 0;
        while (i < end && q < seq_len) {
            if (buf[i] != '\r' && buf[i] != '\n')
                q++;
            i++;
        }
    }
    kb_done(j, &s);
    return NULL;
}

/*
 * The two phases over T ranges: phase 1 counts each range's reads and
 * bases, prefix sums give each its place, phase 2 writes.  `counts`
 * receives {breaks, gap_bytes, reads}.  Returns the number of reads,
 * -(byte index)-1 at the first bad byte (the ranges are disjoint and in
 * order, so the least index of any range is the first), or -n-1 when
 * they exceed max_reads (counts[2] then holds the number needed).
 */
static long long kb_parse_mt(const char *buf, long long n, uint8_t *codes,
                             long long *offsets, long long max_reads,
                             int T, const long long *bounds, const int *mid,
                             void *(*worker)(void *), int skip_invalid,
                             long long *counts)
{
    kb_job jobs[16];
    pthread_t tids[16];
    int t;
    for (int phase = 0; phase < 2; phase++) {
        for (t = 0; t < T; t++) {
            jobs[t].buf = buf;
            jobs[t].start = bounds[t];
            jobs[t].end = bounds[t + 1];
            jobs[t].codes = codes;
            jobs[t].offsets = offsets;
            jobs[t].write = phase;
            jobs[t].mid = mid[t];
            jobs[t].skip_invalid = skip_invalid;
            if (phase == 0)
                jobs[t].code_base = jobs[t].read_base = 0;
            if (T > 1)
                pthread_create(&tids[t], NULL, worker, &jobs[t]);
            else
                worker(&jobs[t]);
        }
        long long err = -1;
        for (t = 0; t < T; t++) {
            if (T > 1)
                pthread_join(tids[t], NULL);
            if (jobs[t].err >= 0 && (err < 0 || jobs[t].err < err))
                err = jobs[t].err;
        }
        if (err >= 0)
            return -err - 1;
        if (phase == 0) {
            long long rsum = 0, wsum = 0, bsum = 0, gsum = 0;
            for (t = 0; t < T; t++) {
                jobs[t].read_base = rsum;
                jobs[t].code_base = wsum;
                rsum += jobs[t].reads;
                wsum += jobs[t].bases;
                bsum += jobs[t].breaks;
                gsum += jobs[t].gap_bytes;
            }
            counts[0] = bsum;
            counts[1] = gsum;
            counts[2] = rsum;
            if (rsum > max_reads)
                return -((long long)1) - n;  /* capacity overflow sentinel */
            offsets[rsum] = wsum;            /* final sentinel offset */
        }
    }
    return counts[2];
}

/*
 * FASTA bytes -> codes and per-read offsets, kn_fasta_encode's contract
 * and output, on nthreads threads (one below 1 MiB).  `splits` receives
 * the interior bounds by kind {record, line, merged}.
 */
long long kb_fasta_encode_mt(const char *buf, long long n, uint8_t *codes,
                             long long *offsets, long long max_reads,
                             int skip_invalid, int nthreads,
                             long long *splits)
{
    long long bounds[17], counts[3];
    int mid[17];
    splits[0] = splits[1] = splits[2] = 0;
    if (nthreads > 16)
        nthreads = 16;
    if (nthreads < 2 || n < (1 << 20))
        return kn_fasta_encode(buf, n, codes, offsets, max_reads,
                               skip_invalid);
    kb_fasta_bounds(buf, n, nthreads, 0, bounds, mid, splits);
    return kb_parse_mt(buf, n, codes, offsets, max_reads, nthreads, bounds,
                       mid, kb_fasta_skip_worker, skip_invalid, counts);
}

/*
 * FASTA (fastq == 0) or FASTQ bytes -> codes and contig offsets, windows
 * broken at non-ACGT runs.  `counts` receives {breaks, gap_bytes, reads,
 * record, line, merged}, the last three a FASTA parse's interior bounds
 * by kind.  Returns the number of contigs (reads), -(byte index)-1 on
 * malformed FASTQ, or -n-1 when they exceed max_reads (counts[2] then
 * holds the number needed, so the caller can size the offsets and call
 * again).
 */
long long kb_encode_break_mt(const char *buf, long long n, uint8_t *codes,
                             long long *offsets, long long max_reads,
                             int nthreads, int fastq, long long *counts)
{
    long long bounds[17];
    int mid[17];
    counts[3] = counts[4] = counts[5] = 0;
    if (nthreads > 16)
        nthreads = 16;
    if (nthreads < 1 || n < (1 << 20))
        nthreads = 1;
    if (fastq)
        kb_fastq_bounds(buf, n, nthreads, bounds, mid);
    else
        kb_fasta_bounds(buf, n, nthreads, 1, bounds, mid, counts + 3);
    return kb_parse_mt(buf, n, codes, offsets, max_reads, nthreads, bounds,
                       mid, fastq ? kb_fastq_worker : kb_fasta_worker, 1,
                       counts);
}
