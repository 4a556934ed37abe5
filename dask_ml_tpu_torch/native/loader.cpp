// Native data loader: multithreaded CSV / raw-f32 ingest.
//
// The reference's ingest layer is dask.dataframe/array readers (external,
// pure-Python orchestration over pandas C parsers).  This framework's
// analogue is a small C++ shim that parses numeric CSV and raw float32
// files into caller-owned row-major buffers with one thread per row range,
// feeding core.sharded.shard_rows / the Incremental streaming path without
// the Python-level tokenize-and-box overhead.
//
// Contract (all functions return 0 on success, negative errno-style codes
// on failure; no exceptions cross the C boundary):
//   dmlt_csv_dims(path, has_header, &rows, &cols)
//   dmlt_csv_read_f32(path, has_header, row_start, rows, cols, out, n_threads)
//   dmlt_bin_read_f32(path, offset_bytes, count, out)
// Streaming session (WINDOWED: the file streams through a ~32 MB window
// — never fully resident, so host memory stays bounded no matter the
// file size; a background worker parses blocks ahead of the consumer
// into a bounded ring).  ``rows`` comes back -1 (unknown without a full
// pre-scan); EOF is dmlt_stream_next's rows_out = 0:
//   dmlt_stream_open(path, has_header, block_rows, n_threads, depth,
//                    &rows, &cols, &err) -> handle (NULL on error)
//   dmlt_stream_next(handle, out, &rows_out)   (rows_out=0 at EOF)
//   dmlt_stream_close(handle)

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct FileBuf {
    char* data = nullptr;
    size_t size = 0;
    ~FileBuf() { std::free(data); }
};

// Read the whole file into memory (CSV parse is CPU-bound; one sequential
// read is the fastest way to feed it).
int read_file(const char* path, FileBuf& buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -errno;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    if (sz < 0) {
        std::fclose(f);
        return -EIO;
    }
    std::fseek(f, 0, SEEK_SET);
    // +1 for a NUL terminator: strtof needs a terminated buffer so a file
    // with no trailing newline cannot read past the allocation.
    buf.data = static_cast<char*>(std::malloc(sz + 1));
    if (!buf.data) {
        std::fclose(f);
        return -ENOMEM;
    }
    size_t got = std::fread(buf.data, 1, sz, f);
    std::fclose(f);
    if (got != static_cast<size_t>(sz)) return -EIO;
    buf.data[sz] = '\0';
    buf.size = sz;
    return 0;
}

// Offsets of line starts for every non-empty line.  memchr (SIMD in
// libc) instead of a byte loop: the index scan is ~5% of parse time on
// a 60MB file with the fast field parser, and this makes it ~free.
// THE line-walk idiom, shared by every scanner (whole-file index,
// streaming-window index, open-time completeness/cols checks) so
// blank-line and termination semantics can never desynchronize between
// them: `next_nonblank` skips blank lines; `line_end_next` returns one
// past this line's '\n', or `end` when the line is unterminated there
// (a line IS terminated iff the returned j has d[j-1] == '\n').
inline size_t next_nonblank(const char* d, size_t i, size_t end) {
    while (i < end && (d[i] == '\n' || d[i] == '\r')) i++;
    return i;
}

inline size_t line_end_next(const char* d, size_t i, size_t end) {
    const char* nl =
        static_cast<const char*>(std::memchr(d + i, '\n', end - i));
    return nl ? static_cast<size_t>(nl - d) + 1 : end;
}

void line_starts(const FileBuf& buf, std::vector<size_t>& starts) {
    const size_t n = buf.size;
    // reserve from an estimated line length to avoid regrowth copies
    starts.reserve(n / 32 + 16);
    size_t i = next_nonblank(buf.data, 0, n);
    while (i < n) {
        starts.push_back(i);
        i = next_nonblank(buf.data, line_end_next(buf.data, i, n), n);
    }
}

long count_cols(const char* line, const char* end) {
    long cols = 1;
    for (const char* p = line; p < end && *p != '\n'; p++)
        if (*p == ',') cols++;
    return cols;
}

// Powers of ten exactly representable in double (10^0..10^22).
const double kPow10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
    1e22,
};

// Fast decimal float parse (Clinger's fast path): uint64 mantissa plus a
// power-of-ten scale, both exact in double, one multiply/divide, cast to
// float.  strtof is locale-aware and ~100 MB/s; this path parses typical
// numeric CSV at several hundred MB/s on one core — which matters here
// because the deploy host exposes a SINGLE core (nproc=1), so the thread
// fan-out can't buy anything.  Returns false (caller falls back to
// strtof) on: >19 significant digits, |decimal exponent| > 22 after
// fraction adjustment, mantissa >= 2^53, or non-numeric forms
// (inf/nan/hex).  The double is correctly rounded, so the float cast is
// within 1 ulp of strtof (double-rounding ties), which is below the
// noise floor of float32 CSV round-trips.
inline bool parse_f32_fast(const char*& p, const char* eol, float* out) {
    const char* s = p;
    bool neg = false;
    if (s < eol && (*s == '+' || *s == '-')) {
        neg = (*s == '-');
        s++;
    }
    uint64_t mant = 0;
    int digs = 0, frac_digits = 0;
    bool any = false;
    while (s < eol && *s >= '0' && *s <= '9') {
        if (++digs > 19) return false;
        mant = mant * 10 + static_cast<uint64_t>(*s - '0');
        any = true;
        s++;
    }
    if (s < eol && *s == '.') {
        s++;
        while (s < eol && *s >= '0' && *s <= '9') {
            if (++digs > 19) return false;
            mant = mant * 10 + static_cast<uint64_t>(*s - '0');
            frac_digits++;
            any = true;
            s++;
        }
    }
    if (!any) return false;
    // "0x1A" / "0X..": the bare-zero mantissa parsed so far is really a
    // hex prefix — punt to strtof rather than return 0 and strand p at 'x'
    if (s < eol && (*s == 'x' || *s == 'X')) return false;
    int exp10 = -frac_digits;
    if (s < eol && (*s == 'e' || *s == 'E')) {
        s++;
        bool eneg = false;
        if (s < eol && (*s == '+' || *s == '-')) {
            eneg = (*s == '-');
            s++;
        }
        int e = 0;
        bool eany = false;
        while (s < eol && *s >= '0' && *s <= '9') {
            if (e < 1000) e = e * 10 + (*s - '0');
            eany = true;
            s++;
        }
        if (!eany) return false;
        exp10 += eneg ? -e : e;
    }
    if (mant >> 53) return false;
    double v;
    if (exp10 >= 0) {
        if (exp10 > 22) return false;
        v = static_cast<double>(mant) * kPow10[exp10];
    } else {
        if (exp10 < -22) return false;
        v = static_cast<double>(mant) / kPow10[-exp10];
    }
    *out = static_cast<float>(neg ? -v : v);
    p = s;
    return true;
}

// Parse rows [r0, r1) into out (already offset by caller).  Each field
// parse is bounded to its own line: a row with fewer than `cols` fields
// errors with -EINVAL instead of silently consuming values from the next
// line (strtof treats '\n' as skippable whitespace), and trailing
// non-delimiter bytes (extra fields) also error.  ``data``/``size`` are
// any NUL-terminated text region (whole file or a streaming window).
void parse_rows(const char* data, size_t size,
                const std::vector<size_t>& starts,
                size_t r0, size_t r1, long cols, float* out, int* err) {
    for (size_t r = r0; r < r1; r++) {
        const char* p = data + starts[r];
        const char* span_end = data + (r + 1 < starts.size() ? starts[r + 1] : size);
        // End of THIS line's content (exclusive of '\n').
        const char* eol = p;
        while (eol < span_end && *eol != '\n') eol++;
        float* row = out + (r - r0) * cols;
        for (long c = 0; c < cols; c++) {
            while (p < eol && (*p == ',' || *p == ' ' || *p == '\t' || *p == '\r')) p++;
            if (p >= eol) {  // too few fields on this row
                *err = -EINVAL;
                return;
            }
            if (!parse_f32_fast(p, eol, &row[c])) {
                char* next = nullptr;
                row[c] = std::strtof(p, &next);
                if (next == p || next > eol) {  // malformed or ran past line
                    *err = -EINVAL;
                    return;
                }
                p = next;
            }
        }
        while (p < eol && (*p == ',' || *p == ' ' || *p == '\t' || *p == '\r')) p++;
        if (p < eol) {  // trailing junk / extra fields
            *err = -EINVAL;
            return;
        }
    }
}

// Parse rows [r0, r1) with an inner thread fan-out (same splitting as
// dmlt_csv_read_f32).  Returns 0 or the first worker's error.
int parse_rows_mt(const char* data, size_t size,
                  const std::vector<size_t>& starts,
                  size_t r0, size_t r1, long cols, float* out,
                  int n_threads) {
    int64_t rows = static_cast<int64_t>(r1 - r0);
    if (n_threads < 1) n_threads = 1;
    if (static_cast<int64_t>(n_threads) > rows) n_threads = rows > 0 ? rows : 1;
    std::vector<std::thread> threads;
    std::vector<int> errs(n_threads, 0);
    int64_t per = (rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t a = t * per;
        int64_t b = std::min(rows, a + per);
        if (a >= b) break;
        threads.emplace_back([&, t, a, b] {
            parse_rows(data, size, starts, r0 + a, r0 + b, cols,
                       out + a * cols, &errs[t]);
        });
    }
    for (auto& th : threads) th.join();
    for (int e : errs)
        if (e) return e;
    return 0;
}

// Streaming window size.  The session's resident set is bounded by
// ~(window + parsed-window floats + depth ring blocks) regardless of
// file size — the whole point of the out-of-core ingest path: a 100 GB
// CSV streams through partial_fit in tens of MB of host memory.
// DMLT_STREAM_WINDOW_BYTES overrides (floor 16) — the adversarial
// window-boundary property tests shrink it to a few bytes' scale so
// tiny files exercise many refill/compact/carry cycles.
size_t stream_window_bytes() {
    // Read ONCE per session at open time, on the CALLER's thread (the
    // worker thread must never call getenv concurrently with Python
    // setenv — glibc may realloc environ under it).  Sessions open
    // fresh, so per-open reads still let the tests flip the knob.
    const char* e = std::getenv("DMLT_STREAM_WINDOW_BYTES");
    constexpr size_t kDefault = 32u << 20;
    if (!e || !*e) return kDefault;
    char* end = nullptr;
    errno = 0;
    long long n = std::strtoll(e, &end, 10);
    if (errno || end == e || *end != '\0' || n <= 0)
        return kDefault;  // typos ("32M") must not shrink a 100 GB
                          // ingest to a byte-scale window silently
    return n >= 16 ? static_cast<size_t>(n) : size_t{16};
}

struct Stream {
    FILE* f = nullptr;
    std::vector<char> win;  // leftover partial line + freshly read bytes
    size_t win_len = 0;     // valid bytes in win
    size_t consumed = 0;    // first unparsed byte
    size_t window_bytes = 32u << 20;  // fixed at open (caller thread)
    bool eof = false;
    long cols = 0;
    int64_t block_rows = 0;
    int n_threads = 1;
    size_t depth = 2;

    struct Block {
        std::vector<float> data;
        int64_t rows = 0;
    };
    Block cur;  // worker-owned accumulating block (may span windows)
    std::deque<Block> ready;
    std::mutex mu;
    std::condition_variable cv_ready;   // consumer waits: a block or EOF/err
    std::condition_variable cv_space;   // worker waits: ring has space
    bool done = false;   // worker finished (EOF or error)
    bool stop = false;   // close() requested
    int err = 0;
    std::thread worker;

    ~Stream() {
        if (f) std::fclose(f);
    }

    // Append up to one window of fresh bytes after the current contents.
    // +1 spare byte so the parse can always NUL-terminate its region.
    int refill() {
        if (eof) return 0;
        const size_t wb = window_bytes;
        if (win.size() < win_len + wb + 1)
            win.resize(win_len + wb + 1);
        size_t got = std::fread(win.data() + win_len, 1, wb, f);
        if (got < wb) {
            if (std::ferror(f)) return -EIO;
            eof = true;
        }
        win_len += got;
        return 0;
    }

    // One past the last parseable byte: through the final newline, or
    // everything once EOF is reached (last line may lack a newline).
    size_t complete_end() const {
        if (eof) return win_len;
        for (size_t i = win_len; i > consumed; i--)
            if (win[i - 1] == '\n') return i;
        return consumed;
    }

    bool push_ready(Block&& b) {  // false = close() raced us; unwind
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return ready.size() < depth || stop; });
        if (stop) return false;
        ready.push_back(std::move(b));
        cv_ready.notify_one();
        return true;
    }

    void fail(int rc) {
        std::lock_guard<std::mutex> lk(mu);
        err = rc;
    }

    void run() {
        std::vector<size_t> starts;
        std::vector<float> wbuf;
        bool stopped = false;
        while (!stopped) {
            {
                std::lock_guard<std::mutex> lk(mu);
                if (stop) break;
            }
            size_t complete = complete_end();
            if (complete > consumed) {
                // index the window's complete lines (shared line-walk:
                // leading blank lines are skipped BEFORE the first push
                // too — after a compact, a region can begin exactly at
                // a blank line, and indexing it as a row would EINVAL
                // legal CSV that the whole-file path accepts)
                starts.clear();
                size_t i = next_nonblank(win.data(), consumed, complete);
                while (i < complete) {
                    starts.push_back(i);
                    i = next_nonblank(
                        win.data(),
                        line_end_next(win.data(), i, complete), complete);
                }
                // NUL-terminate the region for the strtof fallback on the
                // last line; the clobbered byte (the partial tail's first,
                // or the refill spare) is restored before reuse
                char saved = win[complete];
                win[complete] = '\0';
                size_t n_lines = starts.size();
                wbuf.resize(n_lines * static_cast<size_t>(cols));
                int rc = parse_rows_mt(win.data(), complete, starts, 0,
                                       n_lines, cols, wbuf.data(), n_threads);
                if (rc) {
                    // deterministic prefix: re-parse sequentially to find
                    // the first malformed line, deliver every FULL block
                    // before it, then surface the error (the error path
                    // is rare, so the one-line-at-a-time pass is free)
                    size_t good = 0;
                    for (; good < n_lines; good++) {
                        int le = 0;
                        parse_rows(win.data(), complete, starts, good,
                                   good + 1, cols,
                                   wbuf.data() + good * cols, &le);
                        if (le) {
                            rc = le;
                            break;
                        }
                    }
                    n_lines = good;
                }
                win[complete] = saved;
                // slice the parsed window into ring blocks; a block may
                // keep filling across several windows
                size_t off = 0;
                while (off < n_lines) {
                    if (cur.data.empty()) {
                        cur.data.resize(
                            static_cast<size_t>(block_rows) * cols);
                        cur.rows = 0;
                    }
                    size_t take = std::min<size_t>(
                        n_lines - off,
                        static_cast<size_t>(block_rows - cur.rows));
                    std::memcpy(cur.data.data() +
                                    static_cast<size_t>(cur.rows) * cols,
                                wbuf.data() + off * cols,
                                take * cols * sizeof(float));
                    cur.rows += static_cast<int64_t>(take);
                    off += take;
                    if (cur.rows == block_rows) {
                        if (!push_ready(std::move(cur))) {
                            stopped = true;
                            break;
                        }
                        cur = Block();
                    }
                }
                if (rc) {
                    // the malformed line's partial block is dropped (the
                    // consumer gets the error, not a torn block)
                    cur = Block();
                    fail(rc);
                    break;
                }
                consumed = complete;
            }
            if (stopped) break;
            // compact: drop parsed bytes, keep the partial tail at front
            if (consumed > 0) {
                std::memmove(win.data(), win.data() + consumed,
                             win_len - consumed);
                win_len -= consumed;
                consumed = 0;
            }
            if (eof) {
                if (win_len == 0) break;  // fully drained
                continue;  // parse the final unterminated line
            }
            int rc = refill();
            if (rc) {
                fail(rc);
                break;
            }
        }
        if (!stopped && !err && cur.rows > 0) {  // final partial block
            cur.data.resize(static_cast<size_t>(cur.rows) * cols);
            push_ready(std::move(cur));
        }
        std::lock_guard<std::mutex> lk(mu);
        done = true;
        cv_ready.notify_all();
    }
};

}  // namespace

extern "C" {

// Opens a WINDOWED streaming session: the file is read in ~32 MB
// windows and never fully resident, so the session's memory is bounded
// regardless of file size (the >HBM out-of-core contract).  ``rows`` is
// reported as -1 — the total is unknowable without a full pre-scan,
// which would defeat the windowing; consumers learn EOF from
// dmlt_stream_next's rows_out = 0.
void* dmlt_stream_open(const char* path, int has_header, int64_t block_rows,
                       int n_threads, int depth, int64_t* rows, int64_t* cols,
                       int* err) {
    auto* s = new Stream();
    s->f = std::fopen(path, "rb");
    if (!s->f) {
        *err = -errno;
        delete s;
        return nullptr;
    }
    s->block_rows = block_rows > 0 ? block_rows : 1;
    s->n_threads = n_threads > 0 ? n_threads : 1;
    s->depth = depth > 0 ? static_cast<size_t>(depth) : 1;
    s->window_bytes = stream_window_bytes();  // caller thread, once
    size_t skip = has_header ? 1 : 0;

    // read until the first DATA line is complete (its newline in the
    // window, or EOF) so cols can be counted synchronously.  Blank
    // lines don't count: a file starting with '\n' followed by a line
    // longer than the window would otherwise satisfy a naive
    // newline-count check and cols would be read off the TRUNCATED
    // line (explore-profile Hypothesis find, round 5).
    auto first_data_complete = [&]() -> bool {
        const char* d = s->win.data();
        const size_t n = s->win_len;
        size_t i = next_nonblank(d, 0, n);
        size_t complete_lines = 0;  // non-blank lines with a newline
        while (i < n) {
            size_t j = line_end_next(d, i, n);
            if (!(j > i && d[j - 1] == '\n'))
                return false;  // line still open at the window edge
            complete_lines++;
            if (complete_lines > skip) return true;  // header(s) + data
            i = next_nonblank(d, j, n);
        }
        return false;
    };
    for (;;) {
        int rc = s->refill();
        if (rc) {
            *err = rc;
            delete s;
            return nullptr;
        }
        if (s->eof || first_data_complete()) break;
    }

    // line starts of the header (if any) + first data line (the shared
    // line-walk, same semantics as every other scanner)
    std::vector<size_t> starts;
    size_t i = next_nonblank(s->win.data(), 0, s->win_len);
    while (i < s->win_len && starts.size() <= skip) {
        starts.push_back(i);
        i = next_nonblank(
            s->win.data(), line_end_next(s->win.data(), i, s->win_len),
            s->win_len);
    }
    if (starts.size() <= skip) {  // empty or header-only file
        *rows = 0;
        *cols = 0;
        *err = 0;
        s->done = true;  // no worker: EOF immediately
        return s;
    }
    const char* first = s->win.data() + starts[skip];
    const char* end = s->win.data() + (i > starts[skip] ? i : s->win_len);
    s->cols = count_cols(first, end);
    s->consumed = starts[skip];  // worker parses from the first data line
    *rows = -1;  // unknown without a full pre-scan (windowed by design)
    *cols = s->cols;
    *err = 0;
    s->worker = std::thread([s] { s->run(); });
    return s;
}

// Copies the next parsed block into `out` (caller-sized to
// block_rows*cols floats).  rows_out = 0 signals EOF.  Blocks until the
// prefetch worker has a block ready.
int dmlt_stream_next(void* handle, float* out, int64_t* rows_out) {
    auto* s = static_cast<Stream*>(handle);
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_ready.wait(lk, [&] { return !s->ready.empty() || s->done; });
    if (s->ready.empty()) {
        // drained: surface a worker error only AFTER every valid block
        // parsed before it has been delivered (the sequential path's
        // deterministic prefix semantics)
        if (s->err) return s->err;
        *rows_out = 0;  // EOF
        return 0;
    }
    Stream::Block b = std::move(s->ready.front());
    s->ready.pop_front();
    s->cv_space.notify_one();
    lk.unlock();
    std::memcpy(out, b.data.data(), b.data.size() * sizeof(float));
    *rows_out = b.rows;
    return 0;
}

void dmlt_stream_close(void* handle) {
    auto* s = static_cast<Stream*>(handle);
    {
        std::lock_guard<std::mutex> lk(s->mu);
        s->stop = true;
        s->cv_space.notify_all();
    }
    if (s->worker.joinable()) s->worker.join();
    delete s;
}

int dmlt_csv_dims(const char* path, int has_header, int64_t* rows, int64_t* cols) {
    FileBuf buf;
    int rc = read_file(path, buf);
    if (rc) return rc;
    std::vector<size_t> starts;
    line_starts(buf, starts);
    size_t n = starts.size();
    size_t skip = has_header ? 1 : 0;
    if (n <= skip) {
        *rows = 0;
        *cols = 0;
        return 0;
    }
    *rows = static_cast<int64_t>(n - skip);
    const char* first = buf.data + starts[skip];
    const char* end = buf.data + (skip + 1 < n ? starts[skip + 1] : buf.size);
    *cols = count_cols(first, end);
    return 0;
}

int dmlt_csv_read_f32(const char* path, int has_header, int64_t row_start,
                      int64_t rows, int64_t cols, float* out, int n_threads) {
    FileBuf buf;
    int rc = read_file(path, buf);
    if (rc) return rc;
    std::vector<size_t> starts;
    line_starts(buf, starts);
    size_t skip = (has_header ? 1 : 0) + static_cast<size_t>(row_start);
    if (starts.size() < skip + rows) return -ERANGE;
    return parse_rows_mt(buf.data, buf.size, starts, skip, skip + rows, cols,
                         out, n_threads);
}

int dmlt_bin_read_f32(const char* path, int64_t offset_bytes, int64_t count,
                      float* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -errno;
    if (std::fseek(f, offset_bytes, SEEK_SET)) {
        std::fclose(f);
        return -EIO;
    }
    size_t got = std::fread(out, sizeof(float), count, f);
    std::fclose(f);
    return got == static_cast<size_t>(count) ? 0 : -EIO;
}

}  // extern "C"
