// Copy of ibwa_tpu/native/src/sam_text.cpp: the port keeps its own host code.
//
// Native SAM-stage text helpers: the per-read MD/NM walk.
//
// bwa_cal_md1 (bwase.c:243-295) runs for every emitted alignment; the
// Python/numpy version (sam/bwase.py::cal_md1, kept as the oracle) costs
// ~40 us/read — this walk is ~1 us.  The caller extracts the reference
// window once (dbset_extract_sequence semantics, including the l_pac
// truncation) and passes it with its absolute start position.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {
const char kBase[] = "ACGTN";
}

extern "C" {

// cigar: bwa_cigar_t words (op << 29 | len); ncig == 0 means "no cigar"
// (one M span of read_len).  ref covers [pos, pos + ref_len) of the
// concatenated reference space (already truncated at l_pac).  Returns
// the MD string length written to out (NUL-terminated), or -1 if cap is
// too small; *out_nm receives the NM count.
int64_t ibwa_cal_md(const uint32_t* cigar, int32_t ncig, const uint8_t* ref,
                    int64_t ref_len, int64_t pos, int64_t l_pac,
                    const uint8_t* read, int32_t read_len, char* out,
                    int64_t cap, int32_t* out_nm) {
  int64_t nm = 0;
  int64_t x = pos, y = 0, u = 0;
  int64_t w = 0;
  auto put_num = [&](int64_t v) -> bool {
    // manual itoa: the SE-mode MD quirk (computed vs remapped_pos == 0,
    // bwase.c:258) makes nearly every base a "mismatch", so this runs
    // ~read_len times per read — snprintf here was 5 us/read
    char tmp[24];
    int n = 0;
    if (v == 0) {
      tmp[n++] = '0';
    } else {
      uint64_t uv = (uint64_t)v;
      while (uv) {
        tmp[n++] = (char)('0' + uv % 10);
        uv /= 10;
      }
    }
    if (w + n + 1 > cap) return false;
    for (int i = n - 1; i >= 0; --i) out[w++] = tmp[i];
    return true;
  };
  auto span_m = [&](int64_t start_x, int64_t len) -> bool {
    // one M span: ref[start_x - pos .. +len) vs read[y .. y+len)
    const uint8_t* r = ref + (start_x - pos);
    for (int64_t i = 0; i < len; ++i) {
      uint8_t rc = r[i], sc = read[y + i];
      if (rc > 3 || sc > 3 || rc != sc) {
        if (!put_num(u)) return false;
        if (w + 2 > cap) return false;
        out[w++] = kBase[rc > 4 ? 4 : rc];
        u = 0;
        ++nm;
      } else {
        ++u;
      }
    }
    return true;
  };

  if (ncig > 0) {
    for (int32_t ci = 0; ci < ncig; ++ci) {
      uint32_t c = cigar[ci];
      int64_t ln = c & 0x1FFFFFFF;
      int op = c >> 29;
      if (op == 0) {  // M
        int64_t span = l_pac - x;
        if (span > ln) span = ln;
        if (span < 0) span = 0;
        if (span > 0) {
          if (!span_m(x, span)) return -1;
          // note: the Python oracle compares seq[y:y+len(ref)] — len
          // capped by the extraction; y advances by the FULL ln below
        }
        x += ln;
        y += ln;
      } else if (op == 1 || op == 3) {  // I or S
        y += ln;
        if (op == 1) nm += ln;
      } else if (op == 2) {  // D
        if (!put_num(u)) return -1;
        if (w + 1 > cap) return -1;
        out[w++] = '^';
        int64_t span = l_pac - x;
        if (span > ln) span = ln;
        if (span < 0) span = 0;
        for (int64_t i = 0; i < span; ++i) {
          if (w + 1 > cap) return -1;
          uint8_t rc = ref[x - pos + i];
          out[w++] = kBase[rc > 4 ? 4 : rc];
        }
        u = 0;
        x += ln;
        nm += ln;
      }
    }
  } else {
    int64_t span = l_pac - x;
    if (span > read_len) span = read_len;
    if (span < 0) span = 0;
    if (span > 0 && !span_m(x, span)) return -1;
  }
  if (!put_num(u)) return -1;
  if (w + 1 > cap) return -1;
  out[w] = 0;
  *out_nm = (int32_t)nm;
  return w;
}

// Plain-FASTQ -> flat blobs (io/reads.py::load_read_batch semantics,
// which mirrors the reference's kseq+bwa_read_seq fast path for
// untrimmed/unbarcoded input, bwaseqio.c:145-205).  Record layout is
// strict 4-line; a trailing newline-less last line is accepted.
//
// Pass 1 (blobs == null): returns n_reads and writes totals[0..2] =
// {seq_bytes, qual_bytes, name_bytes}; -1 if the file is not 4-line
// FASTQ.  Pass 2 fills seq codes (nt4), qual bytes, processed names
// (@ stripped, first whitespace token, /1 //2 suffix stripped) plus
// their int64 offset arrays (length n+1, caller-zeroed first slot).
int64_t ibwa_fastq_scan(const uint8_t* data, int64_t size,
                        int64_t* totals, uint8_t* seq_blob,
                        int64_t* seq_off, uint8_t* qual_blob,
                        int64_t* qual_off, uint8_t* name_blob,
                        int64_t* name_off) {
  static uint8_t nt4[256];
  static bool init = false;
  if (!init) {
    memset(nt4, 4, sizeof(nt4));
    nt4['A'] = nt4['a'] = 0;
    nt4['C'] = nt4['c'] = 1;
    nt4['G'] = nt4['g'] = 2;
    nt4['T'] = nt4['t'] = 3;
    init = true;
  }
  auto is_space = [](uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v';
  };
  if (size > 0 && data[size - 1] == '\n') --size;  // split+pop semantics
  int64_t n = 0, seq_t = 0, qual_t = 0, name_t = 0;
  int64_t i = 0;
  while (i < size) {
    // one record = 4 newline-terminated lines
    int64_t ls[4], le[4];
    for (int k = 0; k < 4; ++k) {
      if (i > size) return -1;
      ls[k] = i;
      const void* nl = memchr(data + i, '\n', (size_t)(size - i));
      le[k] = nl ? (const uint8_t*)nl - data : size;
      i = le[k] + 1;
    }
    // processed name: skip '@', leading whitespace, first token
    int64_t p = ls[0] + 1;
    while (p < le[0] && is_space(data[p])) ++p;
    int64_t q = p;
    while (q < le[0] && !is_space(data[q])) ++q;
    int64_t nl2 = q - p;
    if (nl2 > 2 && data[q - 2] == '/' &&
        (data[q - 1] == '1' || data[q - 1] == '2'))
      nl2 -= 2;
    int64_t sl = le[1] - ls[1], ql = le[3] - ls[3];
    if (seq_blob) {
      for (int64_t j = 0; j < sl; ++j)
        seq_blob[seq_t + j] = nt4[data[ls[1] + j]];
      memcpy(qual_blob + qual_t, data + ls[3], (size_t)ql);
      memcpy(name_blob + name_t, data + p, (size_t)nl2);
      seq_off[n + 1] = seq_t + sl;
      qual_off[n + 1] = qual_t + ql;
      name_off[n + 1] = name_t + nl2;
    }
    seq_t += sl;
    qual_t += ql;
    name_t += nl2;
    n += 1;
  }
  if (totals) {
    totals[0] = seq_t;
    totals[1] = qual_t;
    totals[2] = name_t;
  }
  return n;
}

}  // extern "C"
