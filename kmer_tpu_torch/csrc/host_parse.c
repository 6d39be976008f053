/*
 * host_parse.c — the port's host parser library.
 *
 * It is native/kmer_native.c, included whole, so every function there
 * keeps its behaviour byte for byte, plus the parsers that break windows
 * at non-ACGT runs (`n_policy` "break", as jellyfish, meryl and KMC
 * count): a maximal run of sequence bytes that CODE_LUT does not encode
 * (N, n, IUPAC letters, anything else but a line end) ends the current
 * contig, and the next base begins a new one with its own offset.  A run
 * at a record's start or end begins nothing, so a record of bases and
 * runs becomes one read per maximal ACGT run (a record with no base stays
 * one empty read, as the skipping parsers give it).  Each contig's
 * windows are then counted as they would be alone.
 *
 * The break is part of the parse's own pass: the same record-aligned
 * thread split and two phases (count, then write) as kn_reads_encode_mt,
 * with the contig offsets emitted where the skipping parser drops the
 * bytes.  Each call also reports `breaks` (contigs begun at a run inside
 * a record) and `gap_bytes` (the non-ACGT sequence bytes, which no window
 * crosses).
 *
 * Build: cc -O3 -shared -fPIC -pthread -o libkmer_native.so host_parse.c
 */

#include "../../native/kmer_native.c"

typedef struct {
    const char *buf;
    long long start, end;     /* record-aligned byte range */
    uint8_t *codes;           /* phase-2 outputs */
    long long *offsets;
    long long code_base, read_base;
    long long reads, bases;   /* phase-1 results */
    long long breaks, gap_bytes;
    long long err;            /* -1 ok, else global byte index of bad input */
    int write;                /* 0 = count, 1 = write */
} kb_job;

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
        if (s.r == 0)  /* headerless leading data: only chunk 0 sees this */
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
 * FASTA (fastq == 0) or FASTQ bytes -> codes and contig offsets, windows
 * broken at non-ACGT runs.  `counts` receives {breaks, gap_bytes, reads}.
 * Returns the number of contigs (reads), -(byte index)-1 on malformed
 * FASTQ, or -n-1 when they exceed max_reads (counts[2] then holds the
 * number needed, so the caller can size the offsets and call again).
 */
long long kb_encode_break_mt(const char *buf, long long n, uint8_t *codes,
                             long long *offsets, long long max_reads,
                             int nthreads, int fastq, long long *counts)
{
    if (nthreads > 16)
        nthreads = 16;
    if (nthreads < 1 || n < (1 << 20))
        nthreads = 1;
    kb_job jobs[16];
    pthread_t tids[16];
    int t, T = nthreads;
    long long bounds[17];
    bounds[0] = 0;
    for (t = 1; t < T; t++) {
        long long pos = n * t / T;
        bounds[t] = fastq ? fastq_boundary(buf, n, pos)
                          : fasta_boundary(buf, n, pos);
        if (bounds[t] < bounds[t - 1])
            bounds[t] = bounds[t - 1];
    }
    bounds[T] = n;
    for (t = 0; t < T; t++) {
        if (bounds[t + 1] < bounds[t])
            bounds[t + 1] = bounds[t];
    }

    for (int phase = 0; phase < 2; phase++) {
        for (t = 0; t < T; t++) {
            jobs[t].buf = buf;
            jobs[t].start = bounds[t];
            jobs[t].end = bounds[t + 1];
            jobs[t].codes = codes;
            jobs[t].offsets = offsets;
            jobs[t].write = phase;
            if (phase == 0)
                jobs[t].code_base = jobs[t].read_base = 0;
            if (T > 1)
                pthread_create(&tids[t], NULL,
                               fastq ? kb_fastq_worker : kb_fasta_worker,
                               &jobs[t]);
            else
                (fastq ? kb_fastq_worker : kb_fasta_worker)(&jobs[t]);
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
