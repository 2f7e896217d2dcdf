// ncio: native BAM window decoder for nanocaller_tpu.
//
// Replaces the hot part of the htslib/pysam data path (SURVEY.md §2.3 N1):
// BGZF block inflation + BAM record decode + CIGAR expansion into packed
// event arrays, the exact structure produced by the pure-Python
// pileup/engine.decode_reads bring-up path (which remains as the
// differential-test oracle).
//
// Interface: C API consumed via ctypes (no pybind11 in this image).
// Python resolves the BAI index and passes virtual-offset chunk ranges;
// this library does the byte crunching and returns an opaque handle whose
// arrays Python copies into numpy.
//
// Build: g++ -O3 -march=native -shared -fPIC ncio.cpp -o libncio.so -lz

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

// libdeflate (when present in the image) is 2-3x faster than zlib for
// the whole-buffer inflate/deflate/crc32 that BGZF blocks are; the
// build probes for it (-DNCIO_USE_LIBDEFLATE -ldeflate) and falls back
// to zlib otherwise. Same bitstreams either way.
#ifdef NCIO_USE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

constexpr int FUNMAP = 0x4;

struct Window {
  // per read
  std::vector<int32_t> flags;
  std::vector<int8_t> strand;
  std::vector<int64_t> read_start, read_end;
  std::vector<int8_t> hp;
  std::vector<int64_t> ps;
  std::string qnames;              // concatenated
  std::vector<int64_t> qname_off;  // size n_reads+1
  std::string seqs;                // concatenated (optional)
  std::vector<int64_t> seq_off;    // size n_reads+1
  // aligned-base events (positions fit int32 for any real genome)
  std::vector<int32_t> ev_rid;
  std::vector<int32_t> ev_pos;
  std::vector<int8_t> ev_code;
  std::vector<int32_t> ev_qpos;
  // deletions / insertions
  std::vector<int32_t> del_rid;
  std::vector<int32_t> del_start, del_len;
  std::vector<int32_t> ins_rid;
  std::vector<int32_t> ins_pos, ins_len;
  // per-column base counts over [start, end): 6 channels
  // A,G,T,C,other(aligned),DEL — accumulated during decode so Python
  // never touches per-base event arrays for counting
  std::vector<int32_t> counts;
  int64_t count_start = 0;
  // deferred-event mode (ncio_decode_defer): accepted record bytes are
  // stashed here so ncio_emit_sites can emit M-op events at a site list
  // computed later (SNP path: counts → candidate/neighbor sites → events)
  // without a second BGZF inflate + record parse.
  std::vector<uint8_t> rec_store;
  std::vector<int64_t> rec_off;
  bool defer_events = false;
  // counts-only mode (CRAM two-phase SNP path): accumulate counts +
  // read metadata but emit no per-base events; the caller re-decodes
  // with a site filter once the candidate/neighbor sites are known.
  bool counts_only = false;
  std::string error;
};

// base codes matching pileup/engine.py: A0 G1 T2 C3 other 4, over the
// 4-bit BAM nibble alphabet "=ACMGRSVTWYHKDBN"
const int8_t NIBBLE_CODE[16] = {4, 0, 3, 4, 1, 4, 4, 4, 2, 4, 4, 4, 4, 4, 4, 4};
const char NIBBLE_CHAR[17] = "=ACMGRSVTWYHKDBN";

class BgzfFile {
 public:
  explicit BgzfFile(const char* path) : fp_(fopen(path, "rb")) {
    if (fp_) setvbuf(fp_, nullptr, _IOFBF, 1 << 20);  // fewer read syscalls
  }
  ~BgzfFile() {
    if (fp_) fclose(fp_);
#ifdef NCIO_USE_LIBDEFLATE
    if (ld_) libdeflate_free_decompressor(ld_);
#endif
  }
  bool ok() const { return fp_ != nullptr; }
  // true once a block failed to load for any reason but a clean EOF (a
  // bad header or size, a short block, a deflate or CRC failure) or a
  // virtual offset pointed past its block: callers raise on it instead
  // of ending as if at EOF
  bool corrupt() const { return corrupt_; }

  // seek to virtual offset
  bool vseek(uint64_t voff) {
    uint64_t coff = voff >> 16;
    uint32_t within = voff & 0xffff;
    if (coff != block_coff_ || !block_valid_) {
      if (!load_block(coff)) return false;
    }
    if (within > block_.size()) return bad();
    within_ = within;
    return true;
  }

  uint64_t vtell() const {
    if (within_ == block_.size() && !block_.empty())
      return next_coff_ << 16;
    return (block_coff_ << 16) | within_;
  }

  // read exactly n bytes; returns false on EOF
  bool read(void* dst, size_t n) {
    uint8_t* out = static_cast<uint8_t*>(dst);
    while (n > 0) {
      if (within_ >= block_.size()) {
        if (!load_block(next_coff_)) return false;
        if (block_.empty()) {
          // empty block (EOF marker) — try next
          if (!load_block(next_coff_)) return false;
          if (block_.empty()) return false;
        }
      }
      size_t take = block_.size() - within_;
      if (take > n) take = n;
      memcpy(out, block_.data() + within_, take);
      within_ += take;
      out += take;
      n -= take;
    }
    return true;
  }

 private:
  bool bad() {
    corrupt_ = true;
    return false;
  }

  bool load_block(uint64_t coff) {
    block_valid_ = false;
    if (fseeko(fp_, coff, SEEK_SET) != 0) return bad();
    uint8_t header[18];
    size_t got = fread(header, 1, 18, fp_);
    if (got == 0) return false;  // EOF
    if (got < 18 || header[0] != 0x1f || header[1] != 0x8b) return bad();
    uint16_t xlen = header[10] | (header[11] << 8);
    std::vector<uint8_t>& extra = extra_;  // reused across blocks
    extra.resize(xlen);
    memcpy(extra.data(), header + 12, 6);
    if (xlen > 6 && fread(extra.data() + 6, 1, xlen - 6, fp_) != size_t(xlen - 6))
      return bad();
    int bsize = -1;
    for (size_t i = 0; i + 4 <= extra.size();) {
      uint8_t si1 = extra[i], si2 = extra[i + 1];
      uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
        break;
      }
      i += 4 + slen;
    }
    if (bsize < 0) return bad();
    int cdata_len = bsize - xlen - 20;
    if (cdata_len < 0) return bad();
    std::vector<uint8_t>& cdata = cdata_;  // reused across blocks
    cdata.resize(cdata_len);
    if (fread(cdata.data(), 1, cdata_len, fp_) != size_t(cdata_len)) return bad();
    uint8_t footer[8];
    if (fread(footer, 1, 8, fp_) != 8) return bad();
    uint32_t isize = footer[4] | (footer[5] << 8) | (footer[6] << 16) |
                     (uint32_t(footer[7]) << 24);
    uint32_t want_crc = footer[0] | (footer[1] << 8) | (footer[2] << 16) |
                        (uint32_t(footer[3]) << 24);
    block_.resize(isize);
    if (isize > 0) {
#ifdef NCIO_USE_LIBDEFLATE
      if (!ld_) ld_ = libdeflate_alloc_decompressor();
      size_t actual = 0;
      if (libdeflate_deflate_decompress(ld_, cdata.data(), cdata_len,
                                        block_.data(), isize, &actual) !=
              LIBDEFLATE_SUCCESS ||
          actual != isize)
        return bad();
      if (libdeflate_crc32(0, block_.data(), isize) != want_crc)
        return bad();  // corruption that still inflated cleanly
#else
      z_stream zs{};
      inflateInit2(&zs, -15);
      zs.next_in = cdata.data();
      zs.avail_in = cdata_len;
      zs.next_out = block_.data();
      zs.avail_out = isize;
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) return bad();
      if (crc32(0, block_.data(), isize) != want_crc) return bad();
#endif
    }
    block_coff_ = coff;
    next_coff_ = coff + bsize;
    within_ = 0;
    block_valid_ = true;
    return true;
  }

  FILE* fp_ = nullptr;
#ifdef NCIO_USE_LIBDEFLATE
  struct libdeflate_decompressor* ld_ = nullptr;
#endif
  std::vector<uint8_t> extra_, cdata_;
  std::vector<uint8_t> block_;
  uint64_t block_coff_ = 0;
  uint64_t next_coff_ = 0;
  size_t within_ = 0;
  bool block_valid_ = false;
  bool corrupt_ = false;
};

int64_t tag_to_int(const uint8_t* p, char typ) {
  switch (typ) {
    case 'c': return *reinterpret_cast<const int8_t*>(p);
    case 'C': return *p;
    case 's': { int16_t v; memcpy(&v, p, 2); return v; }
    case 'S': { uint16_t v; memcpy(&v, p, 2); return v; }
    case 'i': { int32_t v; memcpy(&v, p, 4); return v; }
    case 'I': { uint32_t v; memcpy(&v, p, 4); return v; }
    default: return 0;
  }
}

size_t tag_value_size(char typ, const uint8_t* p, const uint8_t* end) {
  switch (typ) {
    case 'A': case 'c': case 'C': return 1;
    case 's': case 'S': return 2;
    case 'i': case 'I': case 'f': return 4;
    case 'Z': case 'H': {
      const uint8_t* q = p;
      while (q < end && *q) q++;
      return q - p + 1;
    }
    case 'B': {
      if (p + 5 > end) return end - p;
      char sub = char(p[0]);
      uint32_t cnt;
      memcpy(&cnt, p + 1, 4);
      size_t esz = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
      return 5 + size_t(cnt) * esz;
    }
    default: return end - p;  // unknown: consume rest
  }
}

void decode_record(const uint8_t* data, size_t len, int64_t start, int64_t end,
                   int32_t want_rid, int flag_exclude, bool keep_seq,
                   const int64_t* sites, int32_t n_sites, Window* w) {
  if (len < 32) return;
  int32_t ref_id, pos;
  memcpy(&ref_id, data, 4);
  memcpy(&pos, data + 4, 4);
  if (ref_id != want_rid) return;
  uint8_t l_read_name = data[8];
  uint16_t n_cigar;
  memcpy(&n_cigar, data + 12, 2);
  uint16_t flag;
  memcpy(&flag, data + 14, 2);
  int32_t l_seq;
  memcpy(&l_seq, data + 16, 4);
  if (flag & (FUNMAP | flag_exclude)) return;
  if (pos >= end) return;
  // corrupt-field validation: every offset below must land inside the
  // record, and the CIGAR's query consumption must fit l_seq — a flipped
  // bit in any length field otherwise walks the decoder out of bounds.
  // l_read_name includes the NUL, so 0 is invalid (and would underflow
  // the qname append below).
  if (l_seq < 0 || l_read_name == 0 ||
      32 + size_t(l_read_name) + size_t(n_cigar) * 4 +
              size_t(uint32_t(l_seq) + 1) / 2 + size_t(uint32_t(l_seq)) >
          len) {
    w->error = "corrupt BAM record (field lengths exceed record)";
    return;
  }

  size_t off = 32;
  const char* qname = reinterpret_cast<const char*>(data + off);
  off += l_read_name;
  const uint8_t* cigar_p = data + off;
  off += size_t(n_cigar) * 4;
  const uint8_t* seq_p = data + off;
  off += (l_seq + 1) / 2;
  off += l_seq;  // qual

  // reference span + query-consumption check
  int64_t ref_len = 0, q_len = 0;
  for (int k = 0; k < n_cigar; k++) {
    uint32_t v;
    memcpy(&v, cigar_p + 4 * k, 4);
    uint32_t op = v & 0xf, l = v >> 4;
    if (op > 8) {  // BAM defines ops 0-8 only (matches the Python oracle)
      w->error = "corrupt BAM record (invalid CIGAR op)";
      return;
    }
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) ref_len += l;
    if (op == 0 || op == 1 || op == 4 || op == 7 || op == 8) q_len += l;
  }
  if (l_seq == 0 && q_len > 0) return;  // SEQ '*' (legal): no base data
  if (q_len > l_seq) {
    w->error = "corrupt BAM record (CIGAR exceeds sequence length)";
    return;
  }
  if (pos + ref_len <= start) return;

  // tags: HP, PS
  int8_t hp = 0;
  int64_t ps = -1;
  {
    const uint8_t* p = data + off;
    const uint8_t* tag_end = data + len;
    while (p + 3 <= tag_end) {
      char t0 = char(p[0]), t1 = char(p[1]), typ = char(p[2]);
      p += 3;
      size_t vsz = tag_value_size(typ, p, tag_end);
      if (p + vsz > tag_end) break;  // truncated tag value
      if (t0 == 'H' && t1 == 'P' && typ != 'Z' && typ != 'B' && typ != 'f')
        hp = int8_t(tag_to_int(p, typ));
      if (t0 == 'P' && t1 == 'S' && typ != 'Z' && typ != 'B' && typ != 'f')
        ps = tag_to_int(p, typ);
      p += vsz;
    }
  }

  int32_t rid = int32_t(w->flags.size());
  w->flags.push_back(flag);
  w->strand.push_back((flag & 0x10) ? 1 : 0);
  w->read_start.push_back(pos);
  w->hp.push_back(hp);
  w->ps.push_back(ps);
  w->qnames.append(qname, l_read_name - 1);
  w->qname_off.push_back(int64_t(w->qnames.size()));

  if (keep_seq) {
    size_t base = w->seqs.size();
    w->seqs.resize(base + l_seq);
    for (int i = 0; i < l_seq; i++) {
      uint8_t nib = (i & 1) ? (seq_p[i / 2] & 0xf) : (seq_p[i / 2] >> 4);
      w->seqs[base + i] = NIBBLE_CHAR[nib];
    }
  }
  w->seq_off.push_back(int64_t(w->seqs.size()));

  if (w->defer_events) {
    // stash only the prefix the emit passes read (header + name + CIGAR
    // + packed seq) — dropping qual/tags cuts the store (and its
    // memcpy) roughly in half for long reads
    size_t keep = 32 + size_t(l_read_name) + size_t(n_cigar) * 4 +
                  size_t(uint32_t(l_seq) + 1) / 2;
    w->rec_off.push_back(int64_t(w->rec_store.size()));
    w->rec_store.insert(w->rec_store.end(), data, data + keep);
  }

  // CIGAR expansion
  int64_t rpos = pos;
  int32_t qpos = 0;
  for (int k = 0; k < n_cigar; k++) {
    uint32_t v;
    memcpy(&v, cigar_p + 4 * k, 4);
    uint32_t op = v & 0xf;
    int64_t l = v >> 4;
    switch (op) {
      case 0: case 7: case 8: {  // M/=/X
        if (w->defer_events) {
          // counts only (skipped entirely in the indel path's
          // no-counts defer mode); per-base events are emitted later by
          // ncio_emit_sites / ncio_emit_qpos once the site list is known.
          // Bounds are hoisted out of the loop and nibbles decoded
          // pairwise — this is the single hottest loop of the SNP
          // feature path (one iteration per aligned base in the window).
          if (!w->counts.empty()) {
            const int64_t cwidth = int64_t(w->counts.size() / 6);
            int64_t i0 = w->count_start > rpos ? w->count_start - rpos : 0;
            int64_t i1 = l;
            if (rpos + i1 > w->count_start + cwidth)
              i1 = w->count_start + cwidth - rpos;
            if (i0 < i1) {
              int32_t q = qpos + int32_t(i0);
              int32_t* cbase =
                  w->counts.data() + (rpos + i0 - w->count_start) * 6;
              int64_t i = i0;
              if (q & 1) {  // align to an even query position
                cbase[NIBBLE_CODE[seq_p[q >> 1] & 0xf]]++;
                i++; q++; cbase += 6;
              }
              for (; i + 1 < i1; i += 2, q += 2, cbase += 12) {
                uint8_t b = seq_p[q >> 1];
                cbase[NIBBLE_CODE[b >> 4]]++;
                cbase[6 + NIBBLE_CODE[b & 0xf]]++;
              }
              if (i < i1)
                cbase[NIBBLE_CODE[(q & 1) ? (seq_p[q >> 1] & 0xf)
                                          : (seq_p[q >> 1] >> 4)]]++;
            }
          }
        } else if (n_sites > 0) {
          // site-filtered mode: emit events only at the given sorted
          // positions (memory stays O(reads × sites), not O(bases))
          const int64_t* lo =
              std::lower_bound(sites, sites + n_sites, rpos);
          for (const int64_t* s = lo; s < sites + n_sites && *s < rpos + l;
               s++) {
            int64_t i = *s - rpos;
            int32_t q = qpos + int32_t(i);
            uint8_t nib = (q & 1) ? (seq_p[q / 2] & 0xf) : (seq_p[q / 2] >> 4);
            w->ev_rid.push_back(rid);
            w->ev_pos.push_back(int32_t(rpos + i));
            w->ev_code.push_back(NIBBLE_CODE[nib]);
            w->ev_qpos.push_back(q);
          }
        } else {
          for (int64_t i = 0; i < l; i++) {
            int32_t q = qpos + int32_t(i);
            uint8_t nib = (q & 1) ? (seq_p[q / 2] & 0xf) : (seq_p[q / 2] >> 4);
            int8_t code = NIBBLE_CODE[nib];
            w->ev_rid.push_back(rid);
            w->ev_pos.push_back(int32_t(rpos + i));
            w->ev_code.push_back(code);
            w->ev_qpos.push_back(q);
            int64_t col = rpos + i - w->count_start;
            if (col >= 0 && size_t(col * 6) < w->counts.size())
              w->counts[col * 6 + code]++;
          }
        }
        rpos += l;
        qpos += int32_t(l);
        break;
      }
      case 1:  // I
        w->ins_rid.push_back(rid);
        w->ins_pos.push_back(int32_t(rpos - 1));
        w->ins_len.push_back(int32_t(l));
        qpos += int32_t(l);
        break;
      case 2: {  // D
        // site-filtered mode: keep only deletions spanning a site —
        // downstream (site_read_codes span logic) ignores the rest, and
        // whole-contig phasing windows otherwise carry tens of millions
        // of irrelevant deletion events (ONT indel noise)
        bool keep_del = true;
        if (!w->defer_events && n_sites > 0) {
          const int64_t* lo = std::lower_bound(sites, sites + n_sites, rpos);
          keep_del = (lo < sites + n_sites && *lo < rpos + l);
        }
        if (keep_del) {
          w->del_rid.push_back(rid);
          w->del_start.push_back(int32_t(rpos));
          w->del_len.push_back(int32_t(l));
        }
        if (!w->counts.empty()) {
          const int64_t cwidth = int64_t(w->counts.size() / 6);
          int64_t i0 = w->count_start > rpos ? w->count_start - rpos : 0;
          int64_t i1 = l;
          if (rpos + i1 > w->count_start + cwidth)
            i1 = w->count_start + cwidth - rpos;
          if (i0 < i1) {  // deletions wholly past the window: no cells
            int32_t* cbase =
                w->counts.data() + (rpos + i0 - w->count_start) * 6 + 5;
            for (int64_t i = i0; i < i1; i++, cbase += 6) (*cbase)++;
          }
        }
        rpos += l;
        break;
      }
      case 3:  // N
        rpos += l;
        break;
      case 4:  // S
        qpos += int32_t(l);
        break;
      default:
        break;  // H/P
    }
  }
  w->read_end.push_back(rpos);
}

Window* decode_impl(const char* path, int32_t rid, int64_t start, int64_t end,
                    const uint64_t* chunks, int32_t n_chunks,
                    int32_t flag_exclude, int32_t keep_seq,
                    const int64_t* sites, int32_t n_sites, bool defer,
                    bool want_counts = true) {
  auto* w = new Window();
  w->defer_events = defer;
  w->qname_off.push_back(0);
  w->seq_off.push_back(0);
  w->count_start = start;
  if (((defer && want_counts) || (!defer && n_sites == 0)) && end > start &&
      end - start < (int64_t(1) << 31))
    w->counts.assign(size_t(end - start) * 6, 0);
  if (defer) {
    // size the record store up front from the index's compressed span
    // (BGZF for BAM runs ~2-4x; half of each record — qual/tags — is
    // dropped at stash time): avoids the ~2x geometric-growth memcpy
    int64_t comp = 0;
    for (int c = 0; c < n_chunks; c++) {
      if (chunks[2 * c + 1] == 0) continue;
      comp += int64_t((chunks[2 * c + 1] >> 16) - (chunks[2 * c] >> 16));
    }
    if (comp > 0) {
      int64_t est = comp * 2;  // ~4x inflate, ~1/2 kept per record
      if (est > (int64_t(1) << 32)) est = int64_t(1) << 32;
      w->rec_store.reserve(size_t(est));
    }
  }
  BgzfFile f(path);
  if (!f.ok()) {
    w->error = "cannot open file";
    return w;
  }
  std::vector<uint8_t> rec;
  for (int c = 0; c < n_chunks; c++) {
    uint64_t cbeg = chunks[2 * c], cend = chunks[2 * c + 1];
    if (!f.vseek(cbeg)) {
      // a chunk that starts past the file's end holds no records; a
      // block that fails to load is corruption, never a quiet skip
      if (f.corrupt()) {
        w->error = "corrupt BGZF block";
        goto done;
      }
      continue;
    }
    while (true) {
      if (cend != 0 && f.vtell() >= cend) break;
      int32_t block_size;
      if (!f.read(&block_size, 4)) {
        // EOF at a record boundary is only legitimate on an unindexed
        // tail scan; inside an indexed chunk it means the file is
        // truncated, and a block that fails to load is corrupt on any
        // scan — flag both so Python raises instead of silently
        // returning a partial pileup
        if (f.corrupt())
          w->error = "corrupt BGZF block";
        else if (cend != 0)
          w->error = "truncated BAM (EOF inside index chunk)";
        goto done;
      }
      if (block_size <= 0 || block_size > (1 << 27)) {
        w->error = "corrupt BAM record size";
        goto done;
      }
      rec.resize(block_size);
      if (!f.read(rec.data(), block_size)) {
        w->error = "truncated BAM (EOF mid-record)";
        goto done;
      }
      if (cend == 0) {
        // unindexed scan: stop once past the window on this rid
        int32_t r_rid, r_pos;
        memcpy(&r_rid, rec.data(), 4);
        memcpy(&r_pos, rec.data() + 4, 4);
        if (r_rid > rid || (r_rid == rid && r_pos >= end)) goto done;
      }
      decode_record(rec.data(), rec.size(), start, end, rid, flag_exclude,
                    keep_seq != 0, sites, n_sites, w);
    }
  }
done:
  return w;
}

}  // namespace

extern "C" {

// Decode reads in [start, end) of reference `rid` from the given virtual
// offset chunk ranges (pairs of beg,end; n_chunks pairs). A single pair
// (data_start, 0) means "scan until past the region" (no index).
void* ncio_decode(const char* path, int32_t rid, int64_t start, int64_t end,
                  const uint64_t* chunks, int32_t n_chunks,
                  int32_t flag_exclude, int32_t keep_seq,
                  const int64_t* sites, int32_t n_sites) {
  return decode_impl(path, rid, start, end, chunks, n_chunks, flag_exclude,
                     keep_seq, sites, n_sites, /*defer=*/false);
}

// Two-phase decode for the SNP path: this pass fills per-column counts +
// read metadata only (no per-base events) and stashes accepted record
// bytes in the handle; call ncio_emit_sites with the candidate/neighbor
// site list afterwards, then ncio_sizes/ncio_fill as usual.
void* ncio_decode_defer(const char* path, int32_t rid, int64_t start,
                        int64_t end, const uint64_t* chunks, int32_t n_chunks,
                        int32_t flag_exclude, int32_t keep_seq,
                        int32_t want_counts) {
  return decode_impl(path, rid, start, end, chunks, n_chunks, flag_exclude,
                     keep_seq, nullptr, 0, /*defer=*/true,
                     want_counts != 0);
}

// Emit M-op events at the given sorted sites by re-walking the stashed
// records of a deferred handle (identical output to the site-filtered
// branch of decode_record). Frees the record store.
void ncio_emit_sites(void* handle, const int64_t* sites, int32_t n_sites) {
  auto* w = static_cast<Window*>(handle);
  const size_t n = w->rec_off.size();
  for (size_t rid = 0; rid < n; rid++) {
    const uint8_t* data = w->rec_store.data() + w->rec_off[rid];
    int32_t pos;
    memcpy(&pos, data + 4, 4);
    uint8_t l_read_name = data[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, data + 12, 2);
    const uint8_t* cigar_p = data + 32 + l_read_name;
    const uint8_t* seq_p = cigar_p + size_t(n_cigar) * 4;
    int64_t rpos = pos;
    int32_t qpos = 0;
    for (int k = 0; k < n_cigar; k++) {
      uint32_t v;
      memcpy(&v, cigar_p + 4 * k, 4);
      uint32_t op = v & 0xf;
      int64_t l = v >> 4;
      switch (op) {
        case 0: case 7: case 8: {  // M/=/X
          const int64_t* lo = std::lower_bound(sites, sites + n_sites, rpos);
          for (const int64_t* s = lo; s < sites + n_sites && *s < rpos + l;
               s++) {
            int64_t i = *s - rpos;
            int32_t q = qpos + int32_t(i);
            uint8_t nib = (q & 1) ? (seq_p[q / 2] & 0xf) : (seq_p[q / 2] >> 4);
            w->ev_rid.push_back(int32_t(rid));
            w->ev_pos.push_back(int32_t(rpos + i));
            w->ev_code.push_back(NIBBLE_CODE[nib]);
            w->ev_qpos.push_back(q);
          }
          rpos += l;
          qpos += int32_t(l);
          break;
        }
        case 1: qpos += int32_t(l); break;   // I
        case 2: case 3: rpos += l; break;    // D/N
        case 4: qpos += int32_t(l); break;   // S
        default: break;                      // H/P
      }
    }
  }
  // deletions follow the site-filtered decode's rule: keep only
  // site-spanning ones (phase-1 stored them all — sites were unknown)
  size_t kept = 0;
  for (size_t d = 0; d < w->del_rid.size(); d++) {
    int64_t ds = w->del_start[d], de = ds + w->del_len[d];
    const int64_t* lo = std::lower_bound(sites, sites + n_sites, ds);
    if (lo < sites + n_sites && *lo < de) {
      w->del_rid[kept] = w->del_rid[d];
      w->del_start[kept] = w->del_start[d];
      w->del_len[kept] = w->del_len[d];
      kept++;
    }
  }
  w->del_rid.resize(kept);
  w->del_start.resize(kept);
  w->del_len.resize(kept);
  w->rec_store.clear();
  w->rec_store.shrink_to_fit();
  w->rec_off.clear();
  w->rec_off.shrink_to_fit();
}

// Emit query-position-or-next pseudo-events at the given sorted columns
// for EVERY read covering each column (indel path, pysam
// query_position_or_next semantics): qpos of the aligned base at the
// column when one exists (code = base code), else qpos of the first
// aligned base after it (code = -1; trailing-deletion columns get
// last-aligned-qpos + 1), exactly matching what the full event arrays
// yield through _ColumnView.reads_at/signature_groups
// (pileup/indel_features.py). Reads without any M op emit nothing.
// Frees the record store.
void ncio_emit_qpos(void* handle, const int64_t* sites, int32_t n_sites,
                    int32_t keep_store) {
  auto* w = static_cast<Window*>(handle);
  const int64_t* send = sites + n_sites;
  const size_t n = w->rec_off.size();
  for (size_t rid = 0; rid < n; rid++) {
    const uint8_t* data = w->rec_store.data() + w->rec_off[rid];
    int32_t pos;
    memcpy(&pos, data + 4, 4);
    uint8_t l_read_name = data[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, data + 12, 2);
    const uint8_t* cigar_p = data + 32 + l_read_name;
    const uint8_t* seq_p = cigar_p + size_t(n_cigar) * 4;
    const int64_t* s = std::lower_bound(sites, send, int64_t(pos));
    if (s == send) continue;
    int64_t rpos = pos;
    int32_t qpos = 0, last_q_end = 0;
    bool any_m = false;
    for (int k = 0; k < n_cigar && s < send; k++) {
      uint32_t v;
      memcpy(&v, cigar_p + 4 * k, 4);
      uint32_t op = v & 0xf;
      int64_t l = v >> 4;
      switch (op) {
        case 0: case 7: case 8: {  // M/=/X
          any_m = true;
          // columns inside a preceding D/N gap resolve to this op's
          // first query position
          while (s < send && *s < rpos) {
            w->ev_rid.push_back(int32_t(rid));
            w->ev_pos.push_back(int32_t(*s));
            w->ev_code.push_back(-1);
            w->ev_qpos.push_back(qpos);
            s++;
          }
          while (s < send && *s < rpos + l) {
            int32_t q = qpos + int32_t(*s - rpos);
            uint8_t nib = (q & 1) ? (seq_p[q / 2] & 0xf) : (seq_p[q / 2] >> 4);
            w->ev_rid.push_back(int32_t(rid));
            w->ev_pos.push_back(int32_t(*s));
            w->ev_code.push_back(NIBBLE_CODE[nib]);
            w->ev_qpos.push_back(q);
            s++;
          }
          rpos += l;
          qpos += int32_t(l);
          last_q_end = qpos;
          break;
        }
        case 1: case 4: qpos += int32_t(l); break;  // I/S
        case 2: case 3: rpos += l; break;           // D/N
        default: break;                              // H/P
      }
    }
    if (any_m) {
      while (s < send && *s < rpos) {  // columns in a trailing deletion
        w->ev_rid.push_back(int32_t(rid));
        w->ev_pos.push_back(int32_t(*s));
        w->ev_code.push_back(-1);
        w->ev_qpos.push_back(last_q_end);
        s++;
      }
    }
  }
  if (!keep_store) {
    w->rec_store.clear();
    w->rec_store.shrink_to_fit();
    w->rec_off.clear();
    w->rec_off.shrink_to_fit();
  }
}

// Expand query-sequence windows [qstart, qstart+win) (python-slice
// clamping: negative qstart truncates from 0, end clamps to l_seq) from
// the stashed packed records of a deferred handle — the indel path's
// lazy replacement for keep_seq, which expanded EVERY read's full
// sequence (~half the phase-1 decode cost) when only ~160-char windows
// at candidate columns are ever read. Requires emit_qpos(keep_store=1).
// out: caller-allocated n*win chars; out_len: chars written per item.
void ncio_emit_qwin(void* handle, const int32_t* rids,
                    const int32_t* qstarts, int32_t n, int32_t win,
                    char* out, int32_t* out_len) {
  auto* w = static_cast<Window*>(handle);
  char* op = out;
  for (int32_t i = 0; i < n; i++) {
    const uint8_t* data = w->rec_store.data() + w->rec_off[rids[i]];
    uint8_t l_read_name = data[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, data + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, data + 16, 4);
    const uint8_t* seq_p = data + 32 + l_read_name + size_t(n_cigar) * 4;
    int64_t q0 = qstarts[i] < 0 ? 0 : qstarts[i];
    int64_t q1 = int64_t(qstarts[i]) + win;
    if (q1 > l_seq) q1 = l_seq;
    int32_t m = int32_t(q1 > q0 ? q1 - q0 : 0);
    for (int64_t q = q0; q < q1; q++) {
      uint8_t nib = (q & 1) ? (seq_p[q >> 1] & 0xf) : (seq_p[q >> 1] >> 4);
      *op++ = NIBBLE_CHAR[nib];
    }
    out_len[i] = m;
  }
}

// Copy only the aligned-event arrays (second fill of a two-phase indel
// decode: read metadata/seqs were already copied out before emission).
void ncio_fill_events(void* handle, int32_t* ev_rid, int32_t* ev_pos,
                      int8_t* ev_code, int32_t* ev_qpos) {
  auto* w = static_cast<Window*>(handle);
  auto cp = [](auto& vec, auto* dst) {
    if (!vec.empty()) memcpy(dst, vec.data(), vec.size() * sizeof(vec[0]));
  };
  cp(w->ev_rid, ev_rid);
  cp(w->ev_pos, ev_pos);
  cp(w->ev_code, ev_code);
  cp(w->ev_qpos, ev_qpos);
}

void ncio_sizes(void* handle, int64_t* out) {
  auto* w = static_cast<Window*>(handle);
  out[0] = int64_t(w->flags.size());
  out[1] = int64_t(w->ev_rid.size());
  out[2] = int64_t(w->del_rid.size());
  out[3] = int64_t(w->ins_rid.size());
  out[4] = int64_t(w->qnames.size());
  out[5] = int64_t(w->seqs.size());
  out[6] = w->error.empty() ? 0 : 1;
}

void ncio_fill(void* handle, int32_t* flags, int8_t* strand,
               int64_t* read_start, int64_t* read_end, int8_t* hp, int64_t* ps,
               char* qnames, int64_t* qname_off, char* seqs, int64_t* seq_off,
               int32_t* ev_rid, int32_t* ev_pos, int8_t* ev_code,
               int32_t* ev_qpos, int32_t* del_rid, int32_t* del_start,
               int32_t* del_len, int32_t* ins_rid, int32_t* ins_pos,
               int32_t* ins_len) {
  auto* w = static_cast<Window*>(handle);
  auto cp = [](auto& vec, auto* dst) {
    if (!vec.empty()) memcpy(dst, vec.data(), vec.size() * sizeof(vec[0]));
  };
  cp(w->flags, flags);
  cp(w->strand, strand);
  cp(w->read_start, read_start);
  cp(w->read_end, read_end);
  cp(w->hp, hp);
  cp(w->ps, ps);
  if (!w->qnames.empty()) memcpy(qnames, w->qnames.data(), w->qnames.size());
  cp(w->qname_off, qname_off);
  if (!w->seqs.empty()) memcpy(seqs, w->seqs.data(), w->seqs.size());
  cp(w->seq_off, seq_off);
  cp(w->ev_rid, ev_rid);
  cp(w->ev_pos, ev_pos);
  cp(w->ev_code, ev_code);
  cp(w->ev_qpos, ev_qpos);
  cp(w->del_rid, del_rid);
  cp(w->del_start, del_start);
  cp(w->del_len, del_len);
  cp(w->ins_rid, ins_rid);
  cp(w->ins_pos, ins_pos);
  cp(w->ins_len, ins_len);
}

int64_t ncio_counts_width(void* handle) {
  return int64_t(static_cast<Window*>(handle)->counts.size() / 6);
}

void ncio_counts_fill(void* handle, int32_t* out) {
  auto* w = static_cast<Window*>(handle);
  if (!w->counts.empty())
    memcpy(out, w->counts.data(), w->counts.size() * sizeof(int32_t));
}

void ncio_free(void* handle) { delete static_cast<Window*>(handle); }

// ---------------------------------------------------------------------------
// Batched affine-gap NW with traceback — exact port of align/nw.py
// (same recurrences, same prefix-max horizontal trick, same tie-breaks),
// so cigars are identical to the numpy/JAX paths. Used by feature-worker
// processes, which must not touch JAX.
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t NEG_NW = -(int32_t(1) << 28);

// cigar ops appended as uint32 (len<<4 | op); ops: 7'=', 8'X', 1'I', 2'D'
void nw_align_one(const int8_t* q, int n, const int8_t* r, int m,
                  int match, int mismatch, int gap_open, int gap_extend,
                  std::vector<uint32_t>* cigar_out, int64_t* score_out) {
  // never merge runs across pair boundaries in the shared output vector
  const size_t pair_base = cigar_out->size();
  auto push_op = [&](int op, int l) {
    if (l <= 0) return;
    if (cigar_out->size() > pair_base && int(cigar_out->back() & 0xf) == op)
      cigar_out->back() += uint32_t(l) << 4;
    else
      cigar_out->push_back((uint32_t(l) << 4) | op);
  };
  if (n == 0 && m == 0) { *score_out = 0; return; }
  if (n == 0) { *score_out = -(gap_open + int64_t(m - 1) * gap_extend); push_op(2, m); return; }
  if (m == 0) { *score_out = -(gap_open + int64_t(n - 1) * gap_extend); push_op(1, n); return; }

  // int32 scores (|score| ≤ ~20·len ≪ 2^28) double SIMD width
  std::vector<int32_t> H(m + 1), Hprev(m + 1), V(m + 1, NEG_NW), G(m + 1);
  std::vector<int32_t> c(m + 1), M(m + 1);
  std::vector<uint8_t> tb(size_t(n + 1) * (m + 1), 0);
  H[0] = 0;
  for (int j = 1; j <= m; j++) {
    H[j] = -(gap_open + (j - 1) * gap_extend);
    tb[j] = (j == 1) ? 2 : (2 | 8);
  }
  for (int i = 1; i <= n; i++)
    tb[size_t(i) * (m + 1)] = 1 | (i > 1 ? 4 : 0);

  for (int i = 1; i <= n; i++) {
    Hprev = H;
    int32_t H0i = -(gap_open + (i - 1) * gap_extend);
    G[0] = H0i;
    uint8_t* row = &tb[size_t(i) * (m + 1)];
    int8_t qc = q[i - 1];
    for (int j = 1; j <= m; j++) {
      bool is_match = (qc == r[j - 1]) && qc < 4;
      int32_t diag = Hprev[j - 1] + (is_match ? match : mismatch);
      int32_t vh = Hprev[j] - gap_open;
      int32_t vv = V[j] - gap_extend;
      int32_t Vnew = vh > vv ? vh : vv;
      bool v_ext = vv > vh;
      V[j] = Vnew;
      int32_t g = diag > Vnew ? diag : Vnew;
      G[j] = g;
      row[j] = (Vnew > diag) ? 1 : 0;
      if (v_ext) row[j] |= 4;
    }
    // prefix max of c[j] = G[j] - open + j*ext, then Z[j] = M[j-1] - (j-1)e
    for (int j = 0; j <= m; j++) {
      c[j] = G[j] - gap_open + j * gap_extend;
      M[j] = (j == 0) ? c[0] : (M[j - 1] > c[j] ? M[j - 1] : c[j]);
    }
    H[0] = H0i;
    for (int j = 1; j <= m; j++) {
      int32_t Z = M[j - 1] - (j - 1) * gap_extend;
      bool z_ext = (j >= 2) && (M[j - 2] > c[j - 1]);
      if (Z > G[j]) {
        row[j] = (row[j] & 4) | 2;  // came_z wins; preserve v_ext bit
      }
      if (z_ext) row[j] |= 8;
      H[j] = Z > G[j] ? Z : G[j];
    }
  }
  *score_out = H[m];

  // traceback (identical walk to nw.py)
  std::vector<int> ops;
  int i = n, j = m, state = 0;
  while (i > 0 || j > 0) {
    uint8_t cell = tb[size_t(i) * (m + 1) + j];
    if (state == 0) {
      if (j == 0) { state = 1; continue; }
      if (i == 0) { state = 2; continue; }
      int src = cell & 3;
      if (src == 0) {
        ops.push_back((q[i - 1] == r[j - 1] && q[i - 1] < 4) ? 7 : 8);
        i--; j--;
      } else {
        state = src;
      }
    } else if (state == 1) {
      ops.push_back(1);
      bool ext = cell & 4;
      i--;
      if (!ext) state = 0;
    } else {
      ops.push_back(2);
      bool ext = cell & 8;
      j--;
      if (!ext) state = 0;
    }
  }
  for (auto it = ops.rbegin(); it != ops.rend(); ++it) push_op(*it, 1);
}

struct NwBatch {
  std::vector<uint32_t> cigars;   // concatenated (len<<4|op) runs
  std::vector<int64_t> offsets;   // size n_pairs+1 into cigars
  std::vector<int64_t> scores;
};

// ---- inter-pair SIMD NW: NWL pairs in lockstep, int16 lanes ----
//
// Same recurrences, same traceback-bit conventions, same tie-breaks as
// nw_align_one — cell (i,j) of lane k depends only on cells (i',j') with
// i'≤i, j'≤j of the same lane, so lanes padded to the cohort's
// (nmax, mmax) compute exactly the standalone DP within each lane's own
// [0..n_k]×[0..m_k] region; scores are captured at row n_k and traceback
// starts at (n_k, m_k). The lane loops are plain fixed-trip loops that
// g++ -O3 -march=native auto-vectorizes (AVX2/AVX-512 int16).

constexpr int NWL = 16;
constexpr int16_t NEG16 = -16384;

// Banded mode (band_w >= 0): the DP is restricted to the shared diagonal
// corridor d = i - j in [-off_lo, off_hi] (off_* = band_w + the cohort's
// max diagonal drift), out-of-corridor cells behaving as -inf (NEG16 has
// the headroom: in-band scores stay > -15000 by the caller's range
// guard, and dead-region drift is bounded by (go+ge)*nmax < 15000, so
// dead values never win a max against real ones and never underflow).
// A lane's banded result is ACCEPTED only when its score strictly
// exceeds a rigorous upper bound on any alignment whose path leaves the
// corridor — any such path on lane (n, m) that reaches excess e beyond
// the lane's own diagonal range has >= |n-m| + 2(e+1) indels in >= 2
// runs and <= min(n,m) - (e+1) diagonal steps, so
//   U_exit(e) = max(0, min(n,m)-e-1)*match - 2*(go-ge)
//               - (|n-m| + 2e + 2)*ge.
// Strict inequality also excludes equal-score out-of-band paths, so the
// forward tie-break bits along the accepted traceback coincide with the
// full DP's and the cigar is identical by construction (differential:
// tests/test_align.py banded stress). Rejected lanes report ok=false
// and are re-run by the caller at a wider band / full matrix.
void nw_align_simd_block(const int8_t* const* qs, const int* ns,
                         const int8_t* const* rs, const int* ms, int n_in,
                         int match, int mismatch, int gap_open,
                         int gap_extend,
                         std::vector<uint32_t>* per_cigars,  // [n_in]
                         int64_t* scores_out, int band_w = -1,
                         bool* ok_out = nullptr) {
  int nmax = 0, mmax = 0;
  for (int l = 0; l < n_in; l++) {
    if (ns[l] > nmax) nmax = ns[l];
    if (ms[l] > mmax) mmax = ms[l];
  }
  // corridor offsets: band margin + the cohort's max diagonal drift
  int drift_hi = 0, drift_lo = 0;
  for (int l = 0; l < n_in; l++) {
    drift_hi = std::max(drift_hi, ns[l] - ms[l]);
    drift_lo = std::max(drift_lo, ms[l] - ns[l]);
  }
  const bool banded = band_w >= 0 && match > 0;
  const int off_hi = banded ? band_w + std::max(0, drift_hi) : nmax;
  const int off_lo = banded ? band_w + std::max(0, drift_lo) : mmax;
  const int16_t go = int16_t(gap_open), ge = int16_t(gap_extend);
  const int16_t ma = int16_t(match), mi = int16_t(mismatch);

  // transposed codes, lane-major, widened to int16 so the whole inner
  // loop is uniform int16 (full-width vectorization); padding code 4
  // never matches
  std::vector<int16_t> rT(size_t(mmax) * NWL, 4);
  for (int l = 0; l < n_in; l++)
    for (int j = 0; j < ms[l]; j++) rT[size_t(j) * NWL + l] = rs[l][j];

  const size_t W = size_t(mmax) + 1;
  // Double-buffered H (pointer swap, no per-row memcpy): row i writes
  // only [jlo(i)..jhi(i)] into the buffer holding row i-2; every cell
  // the next row reads was either written by row i-1 (it reads that
  // buffer), or is an out-of-corridor cell never written by ANY row of
  // that buffer (jlo/jhi are monotonic in i), still holding the NEG16
  // init. tb is a stale thread-local arena (no zeroing): the traceback
  // of an accepted lane only visits corridor cells, all written.
  std::vector<int16_t> Ha(W * NWL, NEG16), Hb(W * NWL, NEG16),
      V(W * NWL, NEG16);
  int16_t* H = Ha.data();
  int16_t* Hprev = Hb.data();
  // corridor-stride tb layout: row i stores slots for j in
  // [row_origin(i) .. row_origin(i)+corr_w-1], row_origin = max(0,
  // i-off_hi) — compresses the arena to the corridor (cache locality)
  // and degenerates to the dense layout in full mode (corr_w = W).
  const size_t corr_w =
      std::min(W, size_t(off_hi) + size_t(off_lo) + 2);
  thread_local std::vector<uint8_t> tb_arena;
  const size_t tb_need = size_t(nmax + 1) * corr_w * NWL;
  if (tb_arena.size() < tb_need) tb_arena.resize(tb_need);
  uint8_t* tb = tb_arena.data();
  // row 0: real values only inside the corridor (j <= off_lo)
  for (int l = 0; l < NWL; l++) H[l] = 0;
  const size_t row0_hi =
      std::min(std::min(size_t(mmax), size_t(off_lo)), corr_w - 1);
  for (size_t j = 1; j <= row0_hi; j++) {
    int16_t h0 = int16_t(-(go + int(j - 1) * ge));
    uint8_t t0 = (j == 1) ? 2 : uint8_t(2 | 8);
    for (int l = 0; l < NWL; l++) {
      H[j * NWL + l] = h0;
      tb[j * NWL + l] = t0;
    }
  }
  for (int i = 1; i <= std::min(nmax, off_hi); i++) {
    uint8_t tc = uint8_t(1 | (i > 1 ? 4 : 0));
    for (int l = 0; l < NWL; l++) tb[size_t(i) * corr_w * NWL + l] = tc;
  }

  alignas(64) int16_t qc[NWL];
  alignas(64) int16_t Mprev[NWL], Mprev2[NWL], cprev[NWL];
  auto row_origin = [&](int ri) { return size_t(std::max(0, ri - off_hi)); };
  for (int i = 1; i <= nmax; i++) {
    const size_t jlo = size_t(std::max(1, i - off_hi));
    const size_t jhi = size_t(std::min(mmax, i + off_lo));
    if (jlo > jhi) continue;  // row outside the corridor entirely
    std::swap(H, Hprev);  // Hprev now holds row i-1; H holds row i-2
    const int16_t H0i = int16_t(-(go + (i - 1) * ge));
    for (int l = 0; l < NWL; l++)
      qc[l] = (l < n_in && i <= ns[l]) ? int16_t(qs[l][i - 1]) : int16_t(4);
    // bootstrap of the running horizontal prefix max at j = jlo-1:
    // all c[j'] for j' < jlo are out-of-corridor (-inf) on this row,
    // except the j=0 column while i <= off_hi (c[0] = H0i - go)
    if (jlo == 1 && i <= off_hi) {
      for (int l = 0; l < NWL; l++) {
        int16_t c0 = int16_t(H0i - go);
        Mprev[l] = c0;   // M[0]
        Mprev2[l] = NEG16;  // unused until j >= 2
        cprev[l] = c0;   // c[0]
        H[l] = H0i;
      }
    } else {
      for (int l = 0; l < NWL; l++) {
        Mprev[l] = NEG16;
        Mprev2[l] = NEG16;
        cprev[l] = NEG16;
        if (jlo == 1) H[l] = NEG16;
      }
    }
    uint8_t* trow = &tb[size_t(i) * corr_w * NWL] - row_origin(i) * NWL;
    const int16_t* __restrict rTp = rT.data();
    const int16_t* __restrict Hpp = Hprev;
    int16_t* __restrict Hh = H;
    int16_t* __restrict Vv = V.data();
    for (size_t j = jlo; j <= jhi; j++) {
      const int16_t jge = int16_t(int(j) * ge);
      const int16_t j1ge = int16_t(int(j - 1) * ge);
      const int16_t* __restrict hpd = Hpp + (j - 1) * NWL;
      const int16_t* __restrict hpj = Hpp + j * NWL;
      int16_t* __restrict vj = Vv + j * NWL;
      int16_t* __restrict hj = Hh + j * NWL;
      const int16_t* __restrict rj = rTp + (j - 1) * NWL;
      uint8_t* __restrict tj = trow + j * NWL;  // trow pre-shifted by row origin
      const int16_t allow_zext = (j >= 2) ? int16_t(-1) : int16_t(0);
      for (int l = 0; l < NWL; l++) {
        const int16_t is_m =
            int16_t((qc[l] == rj[l]) & (qc[l] < 4) ? -1 : 0);
        const int16_t diag = int16_t(hpd[l] + ((is_m & ma) | (~is_m & mi)));
        const int16_t vh = int16_t(hpj[l] - go);
        const int16_t vv = int16_t(vj[l] - ge);
        const int16_t Vn = vh > vv ? vh : vv;
        vj[l] = Vn;
        const int16_t g = diag > Vn ? diag : Vn;
        const int16_t c = int16_t(g - go + jge);
        const int16_t Z = int16_t(Mprev[l] - j1ge);
        const int16_t zwin = int16_t(Z > g ? -1 : 0);
        int16_t t = int16_t(Vn > diag ? 1 : 0);
        t |= int16_t(vv > vh ? 4 : 0);
        t = int16_t((zwin & ((t & 4) | 2)) | (~zwin & t));
        t |= int16_t(allow_zext & (Mprev2[l] > cprev[l] ? 8 : 0));
        tj[l] = uint8_t(t);
        hj[l] = (zwin & Z) | (~zwin & g);
        Mprev2[l] = Mprev[l];
        Mprev[l] = Mprev[l] > c ? Mprev[l] : c;
        cprev[l] = c;
      }
    }
    for (int l = 0; l < n_in; l++)
      if (ns[l] == i) scores_out[l] = H[size_t(ms[l]) * NWL + l];
  }

  // banded acceptance: score must strictly beat every exit bound
  if (ok_out) {
    for (int l = 0; l < n_in; l++) {
      bool ok = true;
      if (banded) {
        const int64_t n = ns[l], m = ms[l];
        const int64_t mn = std::min(n, m), ad = llabs(n - m);
        const int e_hi = off_hi - int(std::max(int64_t(0), n - m));
        const int e_lo = off_lo - int(std::max(int64_t(0), m - n));
        auto u_exit = [&](int64_t e) {
          int64_t diag = std::max(int64_t(0), mn - e - 1);
          return diag * match - 2 * int64_t(gap_open - gap_extend) -
                 (ad + 2 * e + 2) * gap_extend;
        };
        // a side is reachable only if the corridor edge lies inside
        // the lane's own matrix (d <= n above, -d <= m below)
        if (off_hi + 1 <= n && scores_out[l] <= u_exit(e_hi)) ok = false;
        if (off_lo + 1 <= m && scores_out[l] <= u_exit(e_lo)) ok = false;
      }
      ok_out[l] = ok;
    }
  }

  // per-lane traceback (identical walk to nw_align_one)
  for (int l = 0; l < n_in; l++) {
    if (ok_out && !ok_out[l]) continue;  // rejected: caller re-runs wider
    std::vector<uint32_t>& out = *(per_cigars + l);
    auto push_op = [&](int op, int ln) {
      if (ln <= 0) return;
      if (!out.empty() && int(out.back() & 0xf) == op)
        out.back() += uint32_t(ln) << 4;
      else
        out.push_back((uint32_t(ln) << 4) | op);
    };
    std::vector<int> ops;
    int i = ns[l], j = ms[l], state = 0;
    const int8_t* q = qs[l];
    const int8_t* r = rs[l];
    while (i > 0 || j > 0) {
      uint8_t cell =
          tb[(size_t(i) * corr_w + size_t(j) - row_origin(i)) * NWL + l];
      if (state == 0) {
        if (j == 0) { state = 1; continue; }
        if (i == 0) { state = 2; continue; }
        int src = cell & 3;
        if (src == 0) {
          ops.push_back((q[i - 1] == r[j - 1] && q[i - 1] < 4) ? 7 : 8);
          i--; j--;
        } else {
          state = src;
        }
      } else if (state == 1) {
        ops.push_back(1);
        bool ext = cell & 4;
        i--;
        if (!ext) state = 0;
      } else {
        ops.push_back(2);
        bool ext = cell & 8;
        j--;
        if (!ext) state = 0;
      }
    }
    for (auto it = ops.rbegin(); it != ops.rend(); ++it) push_op(*it, 1);
  }
}

}  // namespace

// queries/refs: concatenated int8 code arrays (A0 C1 G2 T3 other4 — the
// align/nw.py encoding); q_off/r_off: n_pairs+1 offsets.
void* ncio_nw_batch(const int8_t* queries, const int64_t* q_off,
                    const int8_t* refs, const int64_t* r_off,
                    int32_t n_pairs, int32_t match, int32_t mismatch,
                    int32_t gap_open, int32_t gap_extend) {
  auto* b = new NwBatch();
  b->offsets.push_back(0);
  b->scores.resize(n_pairs);
  // int16 range guard for the SIMD cohort path: every intermediate is a
  // partial-alignment score bounded by (amax+ge)·(n+m)+go, plus the
  // NEG16 sentinel headroom
  int amax = std::max({std::abs(match), std::abs(mismatch),
                       std::abs(gap_open) + std::abs(gap_extend)});
  std::vector<std::vector<uint32_t>> per(n_pairs);
  const int8_t* qp[NWL];
  const int8_t* rp[NWL];
  int ns[NWL], ms[NWL], ks[NWL];
  int64_t sc[NWL];
  bool okf[NWL];
  std::vector<int> pend;
  pend.reserve(n_pairs);
  for (int k = 0; k < n_pairs; k++) {
    int n = int(q_off[k + 1] - q_off[k]);
    int m = int(r_off[k + 1] - r_off[k]);
    int64_t bound = int64_t(amax + std::abs(gap_extend)) * (n + m) +
                    std::abs(gap_open);
    if (n == 0 || m == 0 || bound >= 15000) {
      // degenerate or out of int16 range → exact scalar kernel
      nw_align_one(queries + q_off[k], n, refs + r_off[k], m, match,
                   mismatch, gap_open, gap_extend, &per[k], &b->scores[k]);
      continue;
    }
    pend.push_back(k);
  }
  // banded ladder: most pairs verify at a narrow corridor (w=18 covers
  // ~7% divergence at MSA scores, w=48 ~18%); the full-matrix level is
  // the guaranteed-exact backstop, so cigars never depend on the band
  static const int LEVELS[3] = {18, 48, -1};
  for (int li = 0; li < 3 && !pend.empty(); li++) {
    const int w = LEVELS[li];
    if (w >= 0)
      // cohorts of similar diagonal drift share tighter corridors
      std::stable_sort(pend.begin(), pend.end(), [&](int a, int c) {
        return (q_off[a + 1] - q_off[a]) - (r_off[a + 1] - r_off[a]) <
               (q_off[c + 1] - q_off[c]) - (r_off[c + 1] - r_off[c]);
      });
    std::vector<int> next;
    int filled = 0;
    auto flush = [&]() {
      if (!filled) return;
      std::vector<uint32_t> cig[NWL];
      nw_align_simd_block(qp, ns, rp, ms, filled, match, mismatch, gap_open,
                          gap_extend, cig, sc, w, okf);
      for (int l = 0; l < filled; l++) {
        if (okf[l]) {
          per[ks[l]] = std::move(cig[l]);
          b->scores[ks[l]] = sc[l];
        } else {
          next.push_back(ks[l]);
        }
      }
      filled = 0;
    };
    for (int k : pend) {
      qp[filled] = queries + q_off[k];
      rp[filled] = refs + r_off[k];
      ns[filled] = int(q_off[k + 1] - q_off[k]);
      ms[filled] = int(r_off[k + 1] - r_off[k]);
      ks[filled] = k;
      if (++filled == NWL) flush();
    }
    flush();
    pend = std::move(next);
  }
  for (int k = 0; k < n_pairs; k++) {
    b->cigars.insert(b->cigars.end(), per[k].begin(), per[k].end());
    b->offsets.push_back(int64_t(b->cigars.size()));
  }
  return b;
}

void ncio_nw_sizes(void* handle, int64_t* out) {
  auto* b = static_cast<NwBatch*>(handle);
  out[0] = int64_t(b->scores.size());
  out[1] = int64_t(b->cigars.size());
}

void ncio_nw_fill(void* handle, uint32_t* cigars, int64_t* offsets,
                  int64_t* scores) {
  auto* b = static_cast<NwBatch*>(handle);
  if (!b->cigars.empty())
    memcpy(cigars, b->cigars.data(), b->cigars.size() * 4);
  memcpy(offsets, b->offsets.data(), b->offsets.size() * 8);
  if (!b->scores.empty())
    memcpy(scores, b->scores.data(), b->scores.size() * 8);
}

void ncio_nw_free(void* handle) { delete static_cast<NwBatch*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Star-MSA column projection + indel tensor (align/msa.py fast path).
//
// Bit-identical port of project_alignments + msa_tensor (align/msa.py:83-160
// here; formula source: reference generate_indel_pileups.py:53-73): given
// per-read global-alignment cigars vs the reference window, lay out MSA
// columns (per-anchor insertion blocks before each ref column, insertions
// left-aligned), accumulate per-column base counts, and emit the
// (5,width,2) float32 tensor (ch0 = col frequency - ref one-hot,
// ch1 = ref one-hot) plus the -0.01-nudged argmax consensus (gaps removed).
// Codes use the MSA alphabet A0 G1 T2 C3 gap/other 4.
// ---------------------------------------------------------------------------

namespace {

struct MsaOut {
  std::vector<float> tensor;  // 5*width*2
  std::string cns;
};

}  // namespace

extern "C" {

void* ncio_msa_project(const int8_t* read_codes, const int64_t* read_off,
                       int32_t n_reads, const uint32_t* cigar_runs,
                       const int64_t* cigar_off, const int8_t* ref_codes,
                       int32_t ref_len, int32_t width) {
  const int m = ref_len;
  // pass 1: max insertion length per anchor (0..m)
  std::vector<int32_t> ins_len(m + 1, 0);
  for (int rd = 0; rd < n_reads; rd++) {
    int ri = 0;
    for (int64_t k = cigar_off[rd]; k < cigar_off[rd + 1]; k++) {
      uint32_t run = cigar_runs[k];
      int op = int(run & 0xF), l = int(run >> 4);
      if (op == 0 || op == 7 || op == 8) {
        ri += l;
      } else if (op == 1) {
        if (l > ins_len[ri]) ins_len[ri] = l;
      } else if (op == 2 || op == 3) {
        ri += l;
      }
    }
  }
  // column index of each ref position
  std::vector<int64_t> col_of_ref(m);
  int64_t off = 0;
  for (int j = 0; j < m; j++) {
    off += ins_len[j];
    col_of_ref[j] = off++;
  }
  const int64_t total_cols = off + ins_len[m];

  // per-column counts; every row starts as all-gap
  std::vector<int32_t> counts(size_t(total_cols) * 5, 0);
  for (int64_t c = 0; c < total_cols; c++) counts[c * 5 + 4] = n_reads;
  auto put = [&](int64_t col, int8_t code) {
    int b = (code >= 0 && code < 5) ? code : 4;
    counts[col * 5 + 4]--;
    counts[col * 5 + b]++;
  };
  for (int rd = 0; rd < n_reads; rd++) {
    const int8_t* q = read_codes + read_off[rd];
    int qi = 0, ri = 0;
    for (int64_t k = cigar_off[rd]; k < cigar_off[rd + 1]; k++) {
      uint32_t run = cigar_runs[k];
      int op = int(run & 0xF), l = int(run >> 4);
      if (op == 0 || op == 7 || op == 8) {
        for (int t = 0; t < l; t++) put(col_of_ref[ri + t], q[qi + t]);
        qi += l;
        ri += l;
      } else if (op == 1) {
        int64_t start = (ri < m) ? col_of_ref[ri] - ins_len[ri]
                                 : total_cols - ins_len[m];
        for (int t = 0; t < l; t++) put(start + t, q[qi + t]);
        qi += l;
      } else if (op == 2 || op == 3) {
        ri += l;
      } else if (op == 4) {
        qi += l;
      }
    }
  }

  auto* out = new MsaOut();
  out->tensor.assign(size_t(5) * width * 2, 0.0f);
  out->cns.reserve(total_cols);
  static const char REV[] = "AGTC-";
  for (int64_t c = 0; c < total_cols; c++) {
    const int32_t* cc = &counts[c * 5];
    int32_t total = 0;
    for (int b = 0; b < 5; b++) total += cc[b];
    float freq[5];
    for (int b = 0; b < 5; b++)
      freq[b] = float(cc[b]) / float(total);  // matches numpy f32 divide
    // consensus: argmax with -0.01 nudge against '-', first max wins
    // (numpy tmp[:,4] -= 0.01 then argmax, align/msa.py:151-153)
    float best = freq[0];
    int best_b = 0;
    for (int b = 1; b < 5; b++) {
      float v = (b == 4) ? freq[4] - 0.01f : freq[b];
      if (v > best) {
        best = v;
        best_b = b;
      }
    }
    if (best_b != 4) out->cns.push_back(REV[best_b]);
  }
  // ref one-hot per column: '-' except at col_of_ref[j]
  std::vector<int8_t> ref_col(total_cols, 4);
  for (int j = 0; j < m; j++) {
    int8_t rb = ref_codes[j];
    ref_col[col_of_ref[j]] = (rb >= 0 && rb < 5) ? rb : 4;
  }
  const int64_t ncols_t = total_cols < width ? total_cols : width;
  for (int64_t c = 0; c < ncols_t; c++) {
    const int32_t* cc = &counts[c * 5];
    int32_t total = 0;
    for (int b = 0; b < 5; b++) total += cc[b];
    for (int b = 0; b < 5; b++) {
      float freq = float(cc[b]) / float(total);
      float ref_oh = (ref_col[c] == b) ? 1.0f : 0.0f;
      out->tensor[(size_t(b) * width + c) * 2 + 0] = freq - ref_oh;
      out->tensor[(size_t(b) * width + c) * 2 + 1] = ref_oh;
    }
  }
  return out;
}

void ncio_msa_sizes(void* handle, int64_t* out) {
  auto* o = static_cast<MsaOut*>(handle);
  out[0] = int64_t(o->cns.size());
}

void ncio_msa_fill(void* handle, float* tensor, char* cns) {
  auto* o = static_cast<MsaOut*>(handle);
  memcpy(tensor, o->tensor.data(), o->tensor.size() * sizeof(float));
  if (!o->cns.empty()) memcpy(cns, o->cns.data(), o->cns.size());
}

void ncio_msa_free(void* handle) { delete static_cast<MsaOut*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// rANS 4x8 decoder (CRAM 3.0 block method 4) — C++ fast path for
// io/rans.py (same stream format; that module is the oracle + encoder).
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t RANS_L = 1u << 23;
constexpr int TF_SHIFT = 12;
constexpr uint32_t TOTFREQ = 1u << TF_SHIFT;

struct FreqTable {
  uint16_t freq[256] = {0};
  uint16_t cum[257] = {0};
  uint8_t lut[TOTFREQ];  // f -> symbol
  void finalize() {
    uint32_t x = 0;
    for (int s = 0; s < 256; s++) {
      cum[s] = uint16_t(x);
      if (freq[s]) {
        memset(lut + x, s, freq[s]);
        x += freq[s];
      }
    }
    cum[256] = uint16_t(x);
  }
};

// read one (sym -> payload) keyed table with the CRAM run-collapsing
// scheme; calls payload(sym) which must advance *pos
template <typename F>
bool read_keyed(const uint8_t* d, int64_t len, int64_t* pos, F payload) {
  if (*pos >= len) return false;
  int rle = 0;
  int key = d[(*pos)++];
  while (true) {
    if (!payload(key)) return false;
    if (rle) {
      rle--;
      key++;
      continue;
    }
    if (*pos >= len) return false;
    int nxt = d[(*pos)++];
    if (nxt == key + 1) {
      if (*pos >= len) return false;
      rle = d[(*pos)++];
    }
    key = nxt;
    if (key == 0 && rle == 0) return true;
  }
}

bool read_freq(const uint8_t* d, int64_t len, int64_t* pos, uint16_t* out) {
  if (*pos >= len) return false;
  uint32_t f = d[(*pos)++];
  if (f >= 128) {
    if (*pos >= len) return false;
    f = ((f & 0x7F) << 8) | d[(*pos)++];
  }
  *out = uint16_t(f);
  return true;
}

bool read_freq_table(const uint8_t* d, int64_t len, int64_t* pos,
                     FreqTable* t) {
  bool ok = read_keyed(d, len, pos, [&](int sym) {
    return read_freq(d, len, pos, &t->freq[sym]);
  });
  if (ok) t->finalize();
  return ok;
}

}  // namespace

extern "C" {

// Decode a full rANS4x8 stream (9-byte header included) into out.
// Returns 0 on success, nonzero on malformed input.
int32_t ncio_rans_uncompress(const uint8_t* in, int64_t in_len,
                             uint8_t* out, int64_t out_capacity,
                             int64_t* out_len) {
  if (in_len < 9) return 1;
  int order = in[0];
  uint32_t raw_sz;
  memcpy(&raw_sz, in + 5, 4);
  *out_len = raw_sz;
  if (raw_sz == 0) return 0;
  if (int64_t(raw_sz) > out_capacity) return 2;
  int64_t pos = 9;

  auto renorm = [&](uint32_t& x) {
    while (x < RANS_L && pos < in_len) x = (x << 8) | in[pos++];
  };

  if (order == 0) {
    FreqTable t;
    if (!read_freq_table(in, in_len, &pos, &t)) return 3;
    if (pos + 16 > in_len) return 3;
    uint32_t R[4];
    memcpy(R, in + pos, 16);
    pos += 16;
    for (int64_t i = 0; i < int64_t(raw_sz); i++) {
      uint32_t& x = R[i & 3];
      uint32_t f = x & (TOTFREQ - 1);
      uint8_t s = t.lut[f];
      out[i] = s;
      x = t.freq[s] * (x >> TF_SHIFT) + f - t.cum[s];
      renorm(x);
    }
    return 0;
  }
  if (order == 1) {
    std::vector<FreqTable> tables(256);
    std::vector<bool> have(256, false);
    bool ok = read_keyed(in, in_len, &pos, [&](int ctx) {
      have[ctx] = true;
      return read_freq_table(in, in_len, &pos, &tables[ctx]);
    });
    if (!ok) return 3;
    if (pos + 16 > in_len) return 3;
    uint32_t R[4];
    memcpy(R, in + pos, 16);
    pos += 16;
    const int64_t isz4 = int64_t(raw_sz) >> 2;
    uint8_t last[4] = {0, 0, 0, 0};
    for (int64_t i = 0; i < isz4; i++) {
      for (int j = 0; j < 4; j++) {
        uint32_t& x = R[j];
        const FreqTable& t = tables[last[j]];
        uint32_t f = x & (TOTFREQ - 1);
        uint8_t s = t.lut[f];
        out[j * isz4 + i] = s;
        x = t.freq[s] * (x >> TF_SHIFT) + f - t.cum[s];
        renorm(x);
        last[j] = s;
      }
    }
    for (int64_t p = 4 * isz4; p < int64_t(raw_sz); p++) {
      uint32_t& x = R[3];
      const FreqTable& t = tables[last[3]];
      uint32_t f = x & (TOTFREQ - 1);
      uint8_t s = t.lut[f];
      out[p] = s;
      x = t.freq[s] * (x >> TF_SHIFT) + f - t.cum[s];
      renorm(x);
      last[3] = s;
    }
    return 0;
  }
  return 4;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// rANS 4x8 encoder — byte-identical to io/rans.py compress() (same
// normalization and table serialization), so either side can verify the
// other. Caller provides a sufficiently large output buffer.
// ---------------------------------------------------------------------------

namespace {

void normalize_freqs(const int64_t* counts, uint16_t* freqs) {
  int64_t total = 0;
  for (int s = 0; s < 256; s++) total += counts[s];
  memset(freqs, 0, 256 * sizeof(uint16_t));
  if (total == 0) return;
  int64_t assigned = 0;
  int max_sym = 0;
  for (int s = 0; s < 256; s++) {
    if (!counts[s]) continue;
    int64_t f = counts[s] * TOTFREQ / total;
    if (f == 0) f = 1;
    freqs[s] = uint16_t(f);
    assigned += f;
    if (freqs[s] > freqs[max_sym] || freqs[max_sym] == 0) max_sym = s;
  }
  freqs[max_sym] = uint16_t(freqs[max_sym] + (int64_t(TOTFREQ) - assigned));
}

void write_freq(std::vector<uint8_t>& out, uint32_t f) {
  if (f < 128) {
    out.push_back(uint8_t(f));
  } else {
    out.push_back(uint8_t(0x80 | (f >> 8)));
    out.push_back(uint8_t(f & 0xFF));
  }
}

// serialize ascending keys with the CRAM run-collapsing scheme
// (mirrors rans.py _write_keyed_table)
template <typename F>
void write_keyed(std::vector<uint8_t>& out, const std::vector<int>& keys,
                 F payload) {
  size_t i = 0, n = keys.size();
  out.push_back(uint8_t(keys[0]));
  int run_left = 0;
  while (true) {
    payload(keys[i]);
    i++;
    if (run_left) {
      run_left--;
      continue;
    }
    if (i < n) {
      out.push_back(uint8_t(keys[i]));
      if (keys[i] == keys[i - 1] + 1) {
        size_t j = i;
        while (j + 1 < n && keys[j + 1] == keys[j] + 1) j++;
        run_left = int(j - i);
        out.push_back(uint8_t(run_left));
      }
    } else {
      out.push_back(0);
      return;
    }
  }
}

void write_freq_table(std::vector<uint8_t>& out, const uint16_t* freqs) {
  std::vector<int> syms;
  for (int s = 0; s < 256; s++)
    if (freqs[s]) syms.push_back(s);
  write_keyed(out, syms, [&](int s) { write_freq(out, freqs[s]); });
}

struct EncState {
  uint32_t R[4] = {RANS_L, RANS_L, RANS_L, RANS_L};
  std::vector<uint8_t> rev;  // renorm bytes, reversed at the end

  inline void put(int j, uint32_t f, uint32_t c) {
    uint32_t x = R[j];
    const uint32_t x_max = ((RANS_L >> TF_SHIFT) << 8) * f;
    while (x >= x_max) {
      rev.push_back(uint8_t(x & 0xFF));
      x >>= 8;
    }
    R[j] = ((x / f) << TF_SHIFT) + c + (x % f);
  }

  void flush(std::vector<uint8_t>& out) {
    for (int j = 0; j < 4; j++) {
      uint32_t v = R[j];
      out.push_back(uint8_t(v));
      out.push_back(uint8_t(v >> 8));
      out.push_back(uint8_t(v >> 16));
      out.push_back(uint8_t(v >> 24));
    }
    out.insert(out.end(), rev.rbegin(), rev.rend());
  }
};

}  // namespace

extern "C" {

// Returns 0 on success; out buffer must hold the worst case
// (in_len + tables + 9; 260k covers order-1 tables).
int32_t ncio_rans_compress(const uint8_t* in, int64_t in_len, int32_t order,
                           uint8_t* out, int64_t out_capacity,
                           int64_t* out_len) {
  if (order == 1 && in_len < 4) order = 0;
  std::vector<uint8_t> body;
  if (in_len > 0 && order == 0) {
    int64_t counts[256] = {0};
    for (int64_t i = 0; i < in_len; i++) counts[in[i]]++;
    uint16_t freqs[256];
    normalize_freqs(counts, freqs);
    uint16_t cum[257] = {0};
    for (int s = 0; s < 256; s++) cum[s + 1] = cum[s] + freqs[s];
    write_freq_table(body, freqs);
    EncState st;
    for (int64_t i = in_len - 1; i >= 0; i--) {
      uint8_t s = in[i];
      st.put(int(i & 3), freqs[s], cum[s]);
    }
    st.flush(body);
  } else if (in_len > 0) {  // order 1
    const int64_t isz4 = in_len >> 2;
    std::vector<std::vector<int64_t>> counts(256);
    auto bump = [&](int ctx, uint8_t s) {
      if (counts[ctx].empty()) counts[ctx].assign(256, 0);
      counts[ctx][s]++;
    };
    for (int j = 0; j < 4; j++) {
      int64_t seg_start = j * isz4;
      int64_t seg_end = (j < 3) ? (j + 1) * isz4 : in_len;
      int ctx = 0;
      for (int64_t p = seg_start; p < seg_end; p++) {
        bump(ctx, in[p]);
        ctx = in[p];
      }
    }
    std::vector<std::vector<uint16_t>> freqs(256);
    std::vector<std::vector<uint16_t>> cums(256);
    std::vector<int> ctxs;
    for (int c = 0; c < 256; c++) {
      if (counts[c].empty()) continue;
      ctxs.push_back(c);
      freqs[c].resize(256);
      normalize_freqs(counts[c].data(), freqs[c].data());
      cums[c].assign(257, 0);
      for (int s = 0; s < 256; s++)
        cums[c][s + 1] = cums[c][s] + freqs[c][s];
    }
    write_keyed(body, ctxs,
                [&](int c) { write_freq_table(body, freqs[c].data()); });
    EncState st;
    for (int64_t p = in_len - 1; p >= 4 * isz4 - 1 + 1; p--) {
      int ctx = (p > 3 * isz4) ? in[p - 1] : 0;
      uint8_t s = in[p];
      st.put(3, freqs[ctx][s], cums[ctx][s]);
    }
    for (int64_t i = isz4 - 1; i >= 0; i--) {
      for (int j = 3; j >= 0; j--) {
        int64_t p = j * isz4 + i;
        int ctx = (p > j * isz4) ? in[p - 1] : 0;
        uint8_t s = in[p];
        st.put(j, freqs[ctx][s], cums[ctx][s]);
      }
    }
    st.flush(body);
  }
  int64_t total = 9 + int64_t(body.size());
  if (total > out_capacity) return 2;
  out[0] = uint8_t(order);
  uint32_t csz = uint32_t(body.size()), rsz = uint32_t(in_len);
  memcpy(out + 1, &csz, 4);
  memcpy(out + 5, &rsz, 4);
  if (!body.empty()) memcpy(out + 9, body.data(), body.size());
  *out_len = total;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CRAM slice decoder → Window arrays (the CRAM analog of ncio_decode).
//
// Python (io/cram.py) parses the cheap container/compression/slice
// headers, decompresses blocks (gzip via zlib, rANS via this library)
// and hands this function the encoding spec + external/core streams +
// reference segment; the record walk — the Python-loop hot spot — runs
// here and emits the exact event-array structure of the BAM decoder
// above, so pileup/engine consumes both formats identically.
//
// Spec byte layout (produced by cram.py _native_spec):
//   u8 ap_delta, u8 rn_preserved, u8 sub_matrix[5]
//   u8 n_series; each: u8 series_enum, <enc>
//   u16 n_td_lines; each: u16 n_tags; each: u8 c1, u8 c2, u8 typ, <enc>
//   <enc> := u8 codec, params (int32 LE ints):
//     EXTERNAL: i32 cid | HUFFMAN: i32 n, i32 alphabet[n], i32 lens[n]
//     BYTE_ARRAY_LEN: <enc> <enc> | BYTE_ARRAY_STOP: u8 stop, i32 cid
//     BETA: i32 offset, i32 nbits | GAMMA: i32 offset | NULL: -
// ---------------------------------------------------------------------------

namespace cramdec {

enum Series {
  S_BF = 0, S_CF, S_RI, S_RL, S_AP, S_RG, S_RN, S_MF, S_NS, S_NP, S_TS,
  S_NF, S_TL, S_FN, S_FC, S_FP, S_DL, S_BB, S_QQ, S_BS, S_IN, S_SC,
  S_HC, S_PD, S_RS, S_BA, S_QS, S_MQ, S_COUNT
};

struct Enc {
  int codec = -1;  // matches cram.py E_* ids
  int32_t cid = 0;
  uint8_t stop = 0;
  int32_t beta_offset = 0, beta_bits = 0, gamma_offset = 0;
  // huffman canonical
  std::vector<int32_t> alphabet;
  std::vector<int32_t> lens;
  int sub_len = -1, sub_val = -1;  // BYTE_ARRAY_LEN children (index)
};

struct ExtStream {
  const uint8_t* d = nullptr;
  int64_t len = 0, pos = 0;
};

struct CoreBits {
  const uint8_t* d = nullptr;
  int64_t len = 0, pos = 0;
  int bit = 0;
  int read1() {
    if (pos >= len) return -1;
    int v = (d[pos] >> (7 - bit)) & 1;
    if (++bit == 8) {
      bit = 0;
      pos++;
    }
    return v;
  }
  int64_t read(int n) {
    int64_t v = 0;
    for (int i = 0; i < n; i++) {
      int b = read1();
      if (b < 0) return -1;
      v = (v << 1) | b;
    }
    return v;
  }
};

struct Ctx {
  std::vector<Enc> encs;            // flat pool (children by index)
  int series[S_COUNT];              // -1 when absent
  struct Tag { char c1, c2, typ; int enc; };
  std::vector<std::vector<Tag>> td;
  bool ap_delta = true, rn_preserved = true;
  uint8_t sub_matrix[5];
  std::vector<ExtStream> ext;       // indexed by slot
  std::vector<int32_t> ext_cids;
  CoreBits core;
  bool fail = false;

  ExtStream* stream(int32_t cid) {
    for (size_t i = 0; i < ext_cids.size(); i++)
      if (ext_cids[i] == cid) return &ext[i];
    fail = true;
    return nullptr;
  }
};

int parse_enc(const uint8_t* spec, int64_t len, int64_t* pos, Ctx* c);

int32_t rd_i32(const uint8_t* spec, int64_t len, int64_t* pos, Ctx* c) {
  if (*pos + 4 > len) {
    c->fail = true;
    return 0;
  }
  int32_t v;
  memcpy(&v, spec + *pos, 4);
  *pos += 4;
  return v;
}

int parse_enc(const uint8_t* spec, int64_t len, int64_t* pos, Ctx* c) {
  if (*pos >= len) {
    c->fail = true;
    return -1;
  }
  int idx = int(c->encs.size());
  c->encs.emplace_back();
  int codec = spec[(*pos)++];
  c->encs[idx].codec = codec;
  switch (codec) {
    case 0:  // NULL
      break;
    case 1:  // EXTERNAL
      c->encs[idx].cid = rd_i32(spec, len, pos, c);
      break;
    case 3: {  // HUFFMAN
      int32_t n = rd_i32(spec, len, pos, c);
      if (n < 0 || n > 1 << 20) {
        c->fail = true;
        return -1;
      }
      auto& e = c->encs[idx];
      e.alphabet.resize(n);
      e.lens.resize(n);
      for (int i = 0; i < n; i++) e.alphabet[i] = rd_i32(spec, len, pos, c);
      for (int i = 0; i < n; i++) e.lens[i] = rd_i32(spec, len, pos, c);
      break;
    }
    case 4: {  // BYTE_ARRAY_LEN
      int l = parse_enc(spec, len, pos, c);
      int v = parse_enc(spec, len, pos, c);
      c->encs[idx].sub_len = l;
      c->encs[idx].sub_val = v;
      break;
    }
    case 5:  // BYTE_ARRAY_STOP
      if (*pos >= len) {
        c->fail = true;
        return -1;
      }
      c->encs[idx].stop = spec[(*pos)++];
      c->encs[idx].cid = rd_i32(spec, len, pos, c);
      break;
    case 6:  // BETA
      c->encs[idx].beta_offset = rd_i32(spec, len, pos, c);
      c->encs[idx].beta_bits = rd_i32(spec, len, pos, c);
      break;
    case 9:  // GAMMA
      c->encs[idx].gamma_offset = rd_i32(spec, len, pos, c);
      break;
    default:
      c->fail = true;  // unsupported codec → python fallback
      return -1;
  }
  return idx;
}

int64_t ext_itf8(ExtStream* s, Ctx* c) {
  if (!s || s->pos >= s->len) {
    c->fail = true;
    return 0;
  }
  uint8_t b0 = s->d[s->pos++];
  int n_extra = b0 < 0x80 ? 0 : b0 < 0xC0 ? 1 : b0 < 0xE0 ? 2
                : b0 < 0xF0 ? 3 : 4;
  if (s->pos + n_extra > s->len) {
    c->fail = true;
    return 0;
  }
  int64_t v;
  switch (n_extra) {
    case 0: v = b0; break;
    case 1: v = (int64_t(b0 & 0x3F) << 8) | s->d[s->pos]; break;
    case 2:
      v = (int64_t(b0 & 0x1F) << 16) | (int64_t(s->d[s->pos]) << 8) |
          s->d[s->pos + 1];
      break;
    case 3:
      v = (int64_t(b0 & 0x0F) << 24) | (int64_t(s->d[s->pos]) << 16) |
          (int64_t(s->d[s->pos + 1]) << 8) | s->d[s->pos + 2];
      break;
    default:
      v = (int64_t(b0 & 0x0F) << 28) | (int64_t(s->d[s->pos]) << 20) |
          (int64_t(s->d[s->pos + 1]) << 12) |
          (int64_t(s->d[s->pos + 2]) << 4) | (s->d[s->pos + 3] & 0x0F);
      break;
  }
  s->pos += n_extra;
  if (v >= 0x80000000LL) v -= 0x100000000LL;
  return v;
}

int64_t decode_int(int enc_idx, Ctx* c);

int64_t huffman_decode(const Enc& e, Ctx* c) {
  // single zero-length symbol = constant
  if (e.alphabet.size() == 1 && e.lens[0] == 0) return e.alphabet[0];
  // canonical codes: sorted by (len, order); walk bit by bit
  struct P { int32_t len, idx; };
  std::vector<std::pair<int32_t, int32_t>> pairs;
  pairs.reserve(e.alphabet.size());
  for (size_t i = 0; i < e.alphabet.size(); i++)
    pairs.push_back({e.lens[i], int32_t(i)});
  std::sort(pairs.begin(), pairs.end());
  int64_t code = 0;
  int32_t prev_len = pairs[0].first;
  // rebuild codes and compare incrementally with the bit stream
  int64_t have = 0;
  int have_bits = 0;
  size_t pi = 0;
  while (pi < pairs.size()) {
    int32_t ln = pairs[pi].first;
    code <<= (ln - prev_len);
    prev_len = ln;
    while (have_bits < ln) {
      int b = c->core.read1();
      if (b < 0) {
        c->fail = true;
        return 0;
      }
      have = (have << 1) | b;
      have_bits++;
    }
    if (have == code && have_bits == ln) return e.alphabet[pairs[pi].second];
    code++;
    pi++;
    // keep reading when next pair has longer code
  }
  c->fail = true;
  return 0;
}

int64_t decode_int(int enc_idx, Ctx* c) {
  if (enc_idx < 0) {
    c->fail = true;
    return 0;
  }
  const Enc& e = c->encs[enc_idx];
  switch (e.codec) {
    case 1:
      return ext_itf8(c->stream(e.cid), c);
    case 3:
      return huffman_decode(e, c);
    case 6: {
      int64_t v = c->core.read(e.beta_bits);
      if (v < 0) {
        c->fail = true;
        return 0;
      }
      return v - e.beta_offset;
    }
    case 9: {
      int n = 0;
      int b;
      while ((b = c->core.read1()) == 0) n++;
      if (b < 0) {
        c->fail = true;
        return 0;
      }
      int64_t v = 1;
      for (int i = 0; i < n; i++) {
        int bb = c->core.read1();
        if (bb < 0) {
          c->fail = true;
          return 0;
        }
        v = (v << 1) | bb;
      }
      return v - e.gamma_offset;
    }
    default:
      c->fail = true;
      return 0;
  }
}

uint8_t decode_byte(int enc_idx, Ctx* c) {
  if (enc_idx < 0) {
    c->fail = true;
    return 0;
  }
  const Enc& e = c->encs[enc_idx];
  if (e.codec == 1) {
    ExtStream* s = c->stream(e.cid);
    if (!s || s->pos >= s->len) {
      c->fail = true;
      return 0;
    }
    return s->d[s->pos++];
  }
  return uint8_t(decode_int(enc_idx, c));
}

// returns pointer+length into an external stream when possible; else
// copies into scratch
bool decode_bytes(int enc_idx, Ctx* c, const uint8_t** out, int64_t* out_len,
                  std::vector<uint8_t>* scratch) {
  if (enc_idx < 0) {
    c->fail = true;
    return false;
  }
  const Enc& e = c->encs[enc_idx];
  if (e.codec == 5) {  // BYTE_ARRAY_STOP
    ExtStream* s = c->stream(e.cid);
    if (!s) return false;
    int64_t p = s->pos;
    while (p < s->len && s->d[p] != e.stop) p++;
    if (p >= s->len) {
      c->fail = true;
      return false;
    }
    *out = s->d + s->pos;
    *out_len = p - s->pos;
    s->pos = p + 1;
    return true;
  }
  if (e.codec == 4) {  // BYTE_ARRAY_LEN
    int64_t ln = decode_int(e.sub_len, c);
    if (c->fail || ln < 0 || e.sub_val < 0) {
      c->fail = true;
      return false;
    }
    const Enc& v = c->encs[e.sub_val];
    if (v.codec == 1) {
      ExtStream* s = c->stream(v.cid);
      if (!s || s->pos + ln > s->len) {
        c->fail = true;
        return false;
      }
      *out = s->d + s->pos;
      *out_len = ln;
      s->pos += ln;
      return true;
    }
    scratch->resize(size_t(ln));
    for (int64_t i = 0; i < ln; i++)
      (*scratch)[size_t(i)] = decode_byte(e.sub_val, c);
    *out = scratch->data();
    *out_len = ln;
    return !c->fail;
  }
  c->fail = true;
  return false;
}

// ASCII base → engine code (A0 G1 T2 C3 other 4)
inline int8_t base_code(uint8_t ch) {
  switch (ch) {
    case 'A': case 'a': return 0;
    case 'G': case 'g': return 1;
    case 'T': case 't': return 2;
    case 'C': case 'c': return 3;
    default: return 4;
  }
}

// substitution matrix lookup (cram.py _sub_base): ref base + 2-bit code
// → read base char; alts iterate "ACGTN" minus ref
inline char sub_base(const uint8_t* sm, char ref_b, int code) {
  static const char* B5 = "ACGTN";
  int r = 4;
  for (int i = 0; i < 5; i++)
    if (B5[i] == ref_b) r = i;
  uint8_t row = sm[r];
  int slot = 0;
  for (int i = 0; i < 5; i++) {
    if (i == r) continue;
    if (((row >> (6 - 2 * slot)) & 3) == code) return B5[i];
    slot++;
  }
  return 'N';
}

struct Feature {
  char code;
  int64_t fpos;  // 1-based query pos (cumulative)
  int64_t ival = 0;
  const uint8_t* bytes = nullptr;
  int64_t nbytes = 0;
  uint8_t b = 0;
  std::vector<uint8_t> own;  // backing when payload must outlive scratch
};

}  // namespace cramdec

extern "C" {

// Begin a CRAM window decode; returns a Window* handle compatible with
// ncio_sizes/ncio_fill/ncio_counts_*/ncio_free.
// counts-only mode for a window handle (call right after
// ncio_cram_begin, before any feed): per-column counts accumulate but
// no per-base events are materialized.
void ncio_window_counts_only(void* handle) {
  static_cast<Window*>(handle)->counts_only = true;
}

void* ncio_cram_begin(int64_t start, int64_t end, int32_t n_sites) {
  auto* w = new Window();
  w->qname_off.push_back(0);
  w->seq_off.push_back(0);
  w->count_start = start;
  if (n_sites == 0 && end > start && end - start < (int64_t(1) << 31))
    w->counts.assign(size_t(end - start) * 6, 0);
  return w;
}

// Decode one slice's records into the window. Returns 0 on success,
// nonzero for unsupported/corrupt layouts (caller falls back to the
// Python decoder and discards the handle).
int32_t ncio_cram_feed(
    void* handle, const uint8_t* spec, int64_t spec_len,
    const uint8_t* ext_cat, const int64_t* ext_off, const int32_t* ext_cids,
    int32_t n_ext, const uint8_t* core, int64_t core_len,
    const char* refseg, int64_t ref_off0, int64_t ref_seg_len,
    int64_t slice_ref_id, int64_t slice_start, int64_t n_records,
    int64_t record_counter, int32_t want_rid, int64_t start, int64_t end,
    int32_t flag_exclude, int32_t keep_seq, const int64_t* sites,
    int32_t n_sites) {
  using namespace cramdec;
  auto* w = static_cast<Window*>(handle);
  Ctx c;
  int64_t pos = 0;
  if (spec_len < 8) return 1;
  c.ap_delta = spec[pos++] != 0;
  c.rn_preserved = spec[pos++] != 0;
  memcpy(c.sub_matrix, spec + pos, 5);
  pos += 5;
  for (int i = 0; i < S_COUNT; i++) c.series[i] = -1;
  int n_series = spec[pos++];
  for (int i = 0; i < n_series; i++) {
    if (pos >= spec_len) return 1;
    int key = spec[pos++];
    int idx = parse_enc(spec, spec_len, &pos, &c);
    if (c.fail) return 1;
    if (key >= 0 && key < S_COUNT) c.series[key] = idx;
  }
  if (pos + 2 > spec_len) return 1;
  uint16_t n_lines;
  memcpy(&n_lines, spec + pos, 2);
  pos += 2;
  c.td.resize(n_lines);
  for (int li = 0; li < n_lines; li++) {
    uint16_t n_tags;
    if (pos + 2 > spec_len) return 1;
    memcpy(&n_tags, spec + pos, 2);
    pos += 2;
    for (int t = 0; t < n_tags; t++) {
      if (pos + 3 > spec_len) return 1;
      Ctx::Tag tag;
      tag.c1 = char(spec[pos]);
      tag.c2 = char(spec[pos + 1]);
      tag.typ = char(spec[pos + 2]);
      pos += 3;
      tag.enc = parse_enc(spec, spec_len, &pos, &c);
      if (c.fail) return 1;
      c.td[li].push_back(tag);
    }
  }
  c.ext.resize(n_ext);
  c.ext_cids.assign(ext_cids, ext_cids + n_ext);
  for (int i = 0; i < n_ext; i++) {
    c.ext[i].d = ext_cat + ext_off[i];
    c.ext[i].len = ext_off[i + 1] - ext_off[i];
  }
  c.core.d = core;
  c.core.len = core_len;

  std::vector<uint8_t> scratch1, scratch2;
  std::vector<Feature> feats;
  std::string seqbuf;
  int64_t last_ap = slice_start;
  int64_t counter = record_counter;
  char namebuf[32];

  for (int64_t rec = 0; rec < n_records; rec++) {
    int64_t bf = decode_int(c.series[S_BF], &c);
    int64_t cf = decode_int(c.series[S_CF], &c);
    int64_t ref_id = slice_ref_id;
    if (slice_ref_id == -2) ref_id = decode_int(c.series[S_RI], &c);
    int64_t rl = decode_int(c.series[S_RL], &c);
    if (c.fail || rl < 0 || rl > (1 << 28)) return 2;
    int64_t ap;
    if (c.ap_delta) {
      last_ap += decode_int(c.series[S_AP], &c);
      ap = last_ap;
    } else {
      ap = decode_int(c.series[S_AP], &c);
    }
    decode_int(c.series[S_RG], &c);
    const uint8_t* rn = nullptr;
    int64_t rn_len = 0;
    std::vector<uint8_t> rn_own;
    if (c.rn_preserved) {
      decode_bytes(c.series[S_RN], &c, &rn, &rn_len, &scratch1);
      if (rn) rn_own.assign(rn, rn + rn_len);
      rn = rn_own.data();
    }
    int64_t mate_bits = 0;
    if (cf & 0x2) {  // detached
      int64_t mf = decode_int(c.series[S_MF], &c);
      if (!c.rn_preserved) {
        decode_bytes(c.series[S_RN], &c, &rn, &rn_len, &scratch1);
        if (rn) {
          rn_own.assign(rn, rn + rn_len);
          rn = rn_own.data();
        }
      }
      decode_int(c.series[S_NS], &c);
      decode_int(c.series[S_NP], &c);
      decode_int(c.series[S_TS], &c);
      if (mf & 1) mate_bits |= 0x20;
      if (mf & 2) mate_bits |= 0x8;
    } else if (cf & 0x4) {
      decode_int(c.series[S_NF], &c);
    }
    int64_t tl = decode_int(c.series[S_TL], &c);
    int8_t hp = 0;
    int64_t ps_tag = -1;
    if (tl < 0 || (size_t(tl) >= c.td.size() && !(tl == 0 && c.td.empty())))
      return 2;
    if (size_t(tl) < c.td.size()) {
      for (const auto& tag : c.td[size_t(tl)]) {
        const uint8_t* blob = nullptr;
        int64_t blen = 0;
        decode_bytes(tag.enc, &c, &blob, &blen, &scratch2);
        if (c.fail) return 2;
        bool is_hp = tag.c1 == 'H' && tag.c2 == 'P';
        bool is_ps = tag.c1 == 'P' && tag.c2 == 'S';
        if ((is_hp || is_ps) && blob && blen > 0) {
          int64_t v = 0;
          switch (tag.typ) {
            case 'c': v = *reinterpret_cast<const int8_t*>(blob); break;
            case 'C': v = blob[0]; break;
            case 's': if (blen >= 2) { int16_t x; memcpy(&x, blob, 2); v = x; } break;
            case 'S': if (blen >= 2) { uint16_t x; memcpy(&x, blob, 2); v = x; } break;
            case 'i': if (blen >= 4) { int32_t x; memcpy(&x, blob, 4); v = x; } break;
            case 'I': if (blen >= 4) { uint32_t x; memcpy(&x, blob, 4); v = x; } break;
            default: v = 0;
          }
          if (is_hp) hp = int8_t(v);
          if (is_ps) ps_tag = v;
        }
      }
    }
    int64_t flags = bf | mate_bits;
    bool mapped = !(bf & 0x4);
    int64_t this_counter = counter++;

    if (!mapped) {
      // consume bases (+quals), never emitted (pileups skip unmapped)
      bool no_seq = (cf & 0x8) != 0;
      if (!no_seq) {
        const Enc& be = c.encs[c.series[S_BA]];
        if (be.codec == 1) {
          ExtStream* s = c.stream(be.cid);
          if (!s || s->pos + rl > s->len) return 2;
          s->pos += rl;
        } else {
          for (int64_t i = 0; i < rl; i++) decode_byte(c.series[S_BA], &c);
        }
      }
      if (cf & 0x1) {
        const Enc& qe = c.encs[c.series[S_QS]];
        if (qe.codec == 1) {
          ExtStream* s = c.stream(qe.cid);
          if (!s || s->pos + rl > s->len) return 2;
          s->pos += rl;
        } else {
          for (int64_t i = 0; i < rl; i++) decode_byte(c.series[S_QS], &c);
        }
      }
      if (c.fail) return 2;
      continue;
    }

    int64_t fn = decode_int(c.series[S_FN], &c);
    if (c.fail || fn < 0 || fn > (1 << 22)) return 2;
    feats.clear();
    int64_t fpos = 0;
    int64_t ref_span = rl;
    for (int64_t f = 0; f < fn; f++) {
      Feature ft;
      ft.code = char(decode_byte(c.series[S_FC], &c));
      fpos += decode_int(c.series[S_FP], &c);
      ft.fpos = fpos;
      const uint8_t* b = nullptr;
      int64_t bl = 0;
      switch (ft.code) {
        case 'X': ft.b = decode_byte(c.series[S_BS], &c); break;
        case 'B':
          ft.b = decode_byte(c.series[S_BA], &c);
          decode_byte(c.series[S_QS], &c);
          break;
        case 'I':
          decode_bytes(c.series[S_IN], &c, &b, &bl, &scratch1);
          if (b) ft.own.assign(b, b + bl);
          ft.nbytes = bl;
          ref_span -= bl;
          break;
        case 'i':
          ft.b = decode_byte(c.series[S_BA], &c);
          ref_span -= 1;
          break;
        case 'S':
          decode_bytes(c.series[S_SC], &c, &b, &bl, &scratch1);
          if (b) ft.own.assign(b, b + bl);
          ft.nbytes = bl;
          ref_span -= bl;
          break;
        case 'D':
          ft.ival = decode_int(c.series[S_DL], &c);
          ref_span += ft.ival;
          break;
        case 'N':
          ft.ival = decode_int(c.series[S_RS], &c);
          ref_span += ft.ival;
          break;
        case 'H':
          ft.ival = decode_int(c.series[S_HC], &c);
          break;
        case 'P':
          ft.ival = decode_int(c.series[S_PD], &c);
          break;
        case 'Q':
          decode_byte(c.series[S_QS], &c);
          break;
        case 'b':
          decode_bytes(c.series[S_BB], &c, &b, &bl, &scratch1);
          if (b) ft.own.assign(b, b + bl);
          ft.nbytes = bl;
          break;
        case 'q':
          decode_bytes(c.series[S_QQ], &c, &b, &bl, &scratch1);
          break;
        default:
          return 2;
      }
      if (c.fail) return 2;
      ft.bytes = ft.own.empty() ? nullptr : ft.own.data();
      feats.push_back(std::move(ft));
    }
    decode_int(c.series[S_MQ], &c);  // mapq unused by the pileup engine
    if (cf & 0x1) {
      const Enc& qe = c.encs[c.series[S_QS]];
      if (qe.codec == 1) {
        ExtStream* s = c.stream(qe.cid);
        if (!s || s->pos + rl > s->len) return 2;
        s->pos += rl;
      } else {
        for (int64_t i = 0; i < rl; i++) decode_byte(c.series[S_QS], &c);
      }
    }
    if (c.fail) return 2;

    int64_t pos0 = ap - 1;
    bool no_seq = (cf & 0x8) != 0;
    if (ref_id != want_rid || pos0 >= end || pos0 + ref_span <= start ||
        (flags & (FUNMAP | flag_exclude)))
      continue;

    int32_t rid32 = int32_t(w->flags.size());
    w->flags.push_back(int32_t(flags));
    w->strand.push_back((flags & 0x10) ? 1 : 0);
    w->read_start.push_back(pos0);
    w->hp.push_back(hp);
    w->ps.push_back(ps_tag);
    if (c.rn_preserved && rn) {
      w->qnames.append(reinterpret_cast<const char*>(rn), size_t(rn_len));
    } else {
      int n = snprintf(namebuf, sizeof(namebuf), "nc.%lld",
                       (long long)this_counter);
      w->qnames.append(namebuf, size_t(n));
    }
    w->qname_off.push_back(int64_t(w->qnames.size()));

    seqbuf.assign(size_t(rl), 'N');
    int64_t qpos = 0, rpos = pos0;
    bool bad = false;
    auto emit_aligned = [&](int64_t gpos, int64_t gq, char ch) {
      int8_t code = base_code(uint8_t(ch));
      if (!w->counts.empty()) {
        int64_t col = gpos - w->count_start;
        if (col >= 0 && size_t(col * 6) < w->counts.size())
          w->counts[size_t(col * 6 + code)]++;
      }
      if (w->counts_only) return;
      if (n_sites > 0) {
        const int64_t* lo = std::lower_bound(sites, sites + n_sites, gpos);
        if (lo == sites + n_sites || *lo != gpos) return;
      }
      w->ev_rid.push_back(rid32);
      w->ev_pos.push_back(int32_t(gpos));
      w->ev_code.push_back(code);
      w->ev_qpos.push_back(int32_t(gq));
    };
    auto copy_ref = [&](int64_t n) {
      if (qpos + n > rl) {
        bad = true;
        return;
      }
      for (int64_t i = 0; i < n; i++) {
        int64_t roff = rpos + i - ref_off0;
        char ch;
        if (no_seq) {
          ch = 'N';
        } else if (roff >= 0 && roff < ref_seg_len) {
          ch = char(toupper(refseg[roff]));
        } else {
          bad = true;  // ref segment too small → python fallback
          return;
        }
        seqbuf[size_t(qpos + i)] = ch;
        emit_aligned(rpos + i, qpos + i, ch);
      }
      qpos += n;
      rpos += n;
    };
    for (const auto& ft : feats) {
      int64_t gap = ft.fpos - 1 - qpos;
      if (gap < 0) {
        bad = true;
        break;
      }
      copy_ref(gap);
      if (bad) break;
      switch (ft.code) {
        case 'X': {
          if (qpos >= rl) { bad = true; break; }
          int64_t roff = rpos - ref_off0;
          if (roff < 0 || roff >= ref_seg_len) { bad = true; break; }
          char rb = char(toupper(refseg[roff]));
          char qb = sub_base(c.sub_matrix, rb, ft.b);
          seqbuf[size_t(qpos)] = qb;
          emit_aligned(rpos, qpos, qb);
          qpos++;
          rpos++;
          break;
        }
        case 'B':
          if (qpos >= rl) { bad = true; break; }
          seqbuf[size_t(qpos)] = char(ft.b);
          emit_aligned(rpos, qpos, char(ft.b));
          qpos++;
          rpos++;
          break;
        case 'I':
          if (qpos + ft.nbytes > rl) { bad = true; break; }
          if (ft.bytes)
            memcpy(&seqbuf[size_t(qpos)], ft.bytes, size_t(ft.nbytes));
          w->ins_rid.push_back(rid32);
          w->ins_pos.push_back(int32_t(rpos - 1));
          w->ins_len.push_back(int32_t(ft.nbytes));
          qpos += ft.nbytes;
          break;
        case 'i':
          if (qpos >= rl) { bad = true; break; }
          seqbuf[size_t(qpos)] = char(ft.b);
          w->ins_rid.push_back(rid32);
          w->ins_pos.push_back(int32_t(rpos - 1));
          w->ins_len.push_back(1);
          qpos++;
          break;
        case 'S':
          if (qpos + ft.nbytes > rl) { bad = true; break; }
          if (ft.bytes)
            memcpy(&seqbuf[size_t(qpos)], ft.bytes, size_t(ft.nbytes));
          qpos += ft.nbytes;
          break;
        case 'D': {
          // site-filtered mode keeps only site-spanning deletions
          // (same rule as the BAM decoder)
          bool keep_del = !w->counts_only;  // phase-1 discards the window
          if (n_sites > 0 && keep_del) {
            const int64_t* lo =
                std::lower_bound(sites, sites + n_sites, rpos);
            keep_del = (lo < sites + n_sites && *lo < rpos + ft.ival);
          }
          if (keep_del) {
            w->del_rid.push_back(rid32);
            w->del_start.push_back(int32_t(rpos));
            w->del_len.push_back(int32_t(ft.ival));
          }
          if (!w->counts.empty()) {
            for (int64_t i = 0; i < ft.ival; i++) {
              int64_t col = rpos + i - w->count_start;
              if (col >= 0 && size_t(col * 6) < w->counts.size())
                w->counts[size_t(col * 6 + 5)]++;
            }
          }
          rpos += ft.ival;
          break;
        }
        case 'N':
          rpos += ft.ival;
          break;
        case 'b':
          if (qpos + ft.nbytes > rl) { bad = true; break; }
          for (int64_t i = 0; i < ft.nbytes; i++) {
            char ch = char(ft.bytes ? ft.bytes[i] : 'N');
            seqbuf[size_t(qpos + i)] = ch;
            emit_aligned(rpos + i, qpos + i, ch);
          }
          qpos += ft.nbytes;
          rpos += ft.nbytes;
          break;
        default:
          break;  // H/P/Q/q: no seq/event effect
      }
      if (bad) break;
    }
    if (bad) return 2;
    copy_ref(rl - qpos);
    if (bad) return 2;
    w->read_end.push_back(rpos);
    if (keep_seq) w->seqs += seqbuf;
    w->seq_off.push_back(int64_t(w->seqs.size()));
  }
  return c.fail ? 2 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Haplotag re-tagger: stream a region's BAM records, splice HP/PS tags,
// BGZF-write the phased-BAM artifact + BAI index in one C++ pass
// (whatshap haplotag | samtools view equivalent, reference
// indelCaller.py:243-251; replaces the Python fetch→re-encode→bgzf path
// in caller.write_haplotagged_bam, which dominated phasing wall time).
// Record bytes pass through verbatim except the bin field (recomputed,
// like io/bam.py BamWriter.write) and the HP/PS tags.
// ---------------------------------------------------------------------------

namespace {

// Streaming batch BGZF writer: payload accumulates in a bounded buffer;
// once a super-batch of full 65280-byte blocks is pending they are
// deflated by a small thread pool and written, so memory stays O(16 MB)
// regardless of contig size. Virtual offsets are resolved from the
// recorded (payload start → compressed offset) block table via
// payload_voff() after finish(); with a 65280-byte payload the
// worst-case deflate output (+26 B BGZF wrapper) always fits the
// 65536-byte block limit, so block boundaries are final.
class BgzfBatchOut {
 public:
  BgzfBatchOut(const char* path, int level, int n_threads)
      : fp_(fopen(path, "wb")), level_(level), n_threads_(n_threads) {}
  ~BgzfBatchOut() {
    if (fp_) fclose(fp_);
  }
  bool ok() const { return fp_ != nullptr && !bad_; }

  void write(const uint8_t* data, size_t n) {
    buf_.insert(buf_.end(), data, data + n);
    if (buf_.size() >= kSuper) drain(false);
  }

  // force a block boundary here (BamWriter header flush semantics)
  void flush() { drain(true); }

  // global payload offset of the next byte written
  size_t offset() const { return base_ + buf_.size(); }

  bool finish() {
    drain(true);
    starts_.push_back(base_);
    coffs_.push_back(coff_);
    static const uint8_t kEof[28] = {
        0x1f, 0x8b, 0x08, 0x04, 0,    0, 0, 0, 0, 0xff, 0x06, 0, 0x42, 0x43,
        0x02, 0,    0x1b, 0,    0x03, 0, 0, 0, 0, 0,    0,    0, 0,    0};
    fwrite(kEof, 1, 28, fp_);
    fclose(fp_);
    fp_ = nullptr;
    return !bad_;
  }

  // payload offset → BGZF virtual offset (call after finish()).
  // starts_ ends with a sentinel (= total payload size) whose coff is
  // the file size before the EOF block, so an offset at any boundary —
  // including stream end — resolves to the next block with
  // within-offset 0, matching BgzfWriter.tell().
  uint64_t payload_voff(size_t off) const {
    size_t b = size_t(std::upper_bound(starts_.begin(), starts_.end(), off) -
                      starts_.begin()) - 1;
    return (coffs_[b] << 16) | uint64_t(off - starts_[b]);
  }

 private:
  // compress+write all complete blocks (and the trailing partial block
  // too when `all`), leaving the remainder buffered
  void drain(bool all) {
    size_t take = all ? buf_.size() : (buf_.size() / kPayload) * kPayload;
    if (take == 0 || bad_) return;
    size_t n_blocks = (take + kPayload - 1) / kPayload;
    std::vector<std::vector<uint8_t>> blocks(n_blocks);
    int nt = int(n_blocks < size_t(n_threads_) ? n_blocks : n_threads_);
    std::vector<int> bad(nt, 0);
    auto work = [&](int t) {
#ifdef NCIO_USE_LIBDEFLATE
      // NULL for levels outside libdeflate's [0,12] — treat as failure
      // rather than dereferencing (the ctypes caller falls back)
      struct libdeflate_compressor* lc = libdeflate_alloc_compressor(level_);
      if (lc == nullptr) { bad[t] = 1; return; }
#endif
      for (size_t b = t; b < n_blocks; b += nt) {
        size_t off = b * kPayload;
        size_t n = (off + kPayload <= take) ? kPayload : take - off;
        const uint8_t* p = buf_.data() + off;
        std::vector<uint8_t>& out = blocks[b];
        out.resize(26 + n + n / 16 + 128);
        size_t clen;
#ifdef NCIO_USE_LIBDEFLATE
        clen = libdeflate_deflate_compress(lc, p, n, out.data() + 18,
                                           out.size() - 26);
        if (clen == 0) { bad[t] = 1; break; }
        uint32_t crc = libdeflate_crc32(0, p, n);
#else
        z_stream zs{};
        if (deflateInit2(&zs, level_, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) {
          bad[t] = 1;
          break;
        }
        zs.next_in = const_cast<uint8_t*>(p);
        zs.avail_in = uInt(n);
        zs.next_out = out.data() + 18;
        zs.avail_out = uInt(out.size() - 26);
        int drc = deflate(&zs, Z_FINISH);
        clen = out.size() - 26 - zs.avail_out;
        deflateEnd(&zs);
        if (drc != Z_STREAM_END) {
          bad[t] = 1;
          break;
        }
        uint32_t crc = crc32(0, p, uInt(n));
#endif
        size_t bsize = clen + 26;
        if (bsize > 65536) { bad[t] = 1; break; }
        uint8_t hdr[18] = {0x1f, 0x8b, 0x08, 0x04, 0,    0, 0, 0, 0,
                           0xff, 0x06, 0,    0x42, 0x43, 0x02, 0, 0, 0};
        hdr[16] = uint8_t((bsize - 1) & 0xff);
        hdr[17] = uint8_t((bsize - 1) >> 8);
        memcpy(out.data(), hdr, 18);
        uint32_t isize = uint32_t(n);
        uint8_t* foot = out.data() + 18 + clen;
        foot[0] = uint8_t(crc); foot[1] = uint8_t(crc >> 8);
        foot[2] = uint8_t(crc >> 16); foot[3] = uint8_t(crc >> 24);
        foot[4] = uint8_t(isize); foot[5] = uint8_t(isize >> 8);
        foot[6] = uint8_t(isize >> 16); foot[7] = uint8_t(isize >> 24);
        out.resize(bsize);
      }
#ifdef NCIO_USE_LIBDEFLATE
      libdeflate_free_compressor(lc);
#endif
    };
    std::vector<std::thread> ths;
    for (int t = 1; t < nt; t++) ths.emplace_back(work, t);
    work(0);
    for (auto& th : ths) th.join();
    for (int t = 0; t < nt; t++)
      if (bad[t]) bad_ = true;
    if (bad_) return;
    for (size_t b = 0; b < n_blocks; b++) {
      starts_.push_back(base_ + b * kPayload);
      coffs_.push_back(coff_);
      fwrite(blocks[b].data(), 1, blocks[b].size(), fp_);
      coff_ += blocks[b].size();
    }
    buf_.erase(buf_.begin(), buf_.begin() + take);
    base_ += take;
  }

  static constexpr size_t kPayload = 65280;
  static constexpr size_t kSuper = 256 * kPayload;  // ~16 MB
  FILE* fp_;
  int level_;
  int n_threads_;
  bool bad_ = false;
  std::vector<uint8_t> buf_;
  size_t base_ = 0;
  uint64_t coff_ = 0;
  std::vector<size_t> starts_;
  std::vector<uint64_t> coffs_;
};

int32_t hbin(int64_t beg, int64_t end) {  // reg2bin (io/bam.py:183)
  end -= 1;
  if (beg >> 14 == end >> 14) return int32_t(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return int32_t(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return int32_t(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return int32_t(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return int32_t(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

void put_i32(std::vector<uint8_t>* v, int32_t x) {
  v->push_back(uint8_t(x)); v->push_back(uint8_t(x >> 8));
  v->push_back(uint8_t(x >> 16)); v->push_back(uint8_t(x >> 24));
}
void put_u64(std::vector<uint8_t>* v, uint64_t x) {
  for (int i = 0; i < 8; i++) v->push_back(uint8_t(x >> (8 * i)));
}

}  // namespace

extern "C" {

// Returns 0 on success, 2 when the input is corrupt (a BGZF block that
// fails to load, a bad record size, a record cut short) and 1 when the
// output cannot be written. hdr: raw uncompressed BAM header bytes
// ("BAM\1"…refs). Tags: n_tags qnames (concatenated, offsets) with hp/ps
// values; existing HP/PS tags on a matched read are removed and replaced
// with HP:c and PS:{c,s,i} encodings matching io/bam._encode_tag.
int32_t ncio_haplotag(const char* in_path, const char* out_path,
                      int32_t want_rid, int64_t start, int64_t end,
                      const uint64_t* chunks, int32_t n_chunks,
                      const uint8_t* hdr, int64_t hdr_len, int32_t n_ref,
                      const char* tag_qnames, const int64_t* tag_off,
                      const int8_t* tag_hp, const int64_t* tag_ps,
                      int32_t n_tags, int32_t level, int32_t threads) {
  BgzfFile in(in_path);
  if (!in.ok()) return 1;
  // threads <= 0: auto (min(hw, 4)); callers overlapping this write
  // with other CPU work pass an explicit budget so the deflate pool
  // doesn't oversubscribe the worker cores
  int n_threads = threads > 0 ? int(threads)
                              : int(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 4) n_threads = 4;
  BgzfBatchOut out(out_path, level, n_threads);
  if (!out.ok()) return 1;
  out.write(hdr, size_t(hdr_len));
  out.flush();  // block boundary after header (BamWriter.__init__)

  // qname → tag index
  struct TagKey { const char* p; size_t n; };
  auto key_of = [&](int i) {
    return std::string(tag_qnames + tag_off[i],
                       size_t(tag_off[i + 1] - tag_off[i]));
  };
  std::vector<std::pair<std::string, int>> tag_list;
  tag_list.reserve(n_tags);
  for (int i = 0; i < n_tags; i++) tag_list.push_back({key_of(i), i});
  std::sort(tag_list.begin(), tag_list.end());

  // per-record BAI raw data; payload offsets are mapped to virtual
  // offsets after parallel compression fixes the block layout
  struct RecMeta { int32_t bin; int64_t pos, ref_end; size_t beg, end; };
  std::vector<RecMeta> recs_meta;

  std::vector<uint8_t> rec, edited;
  bool done = false;
  for (int c = 0; c < n_chunks && !done; c++) {
    uint64_t cbeg = chunks[2 * c], cend = chunks[2 * c + 1];
    if (!in.vseek(cbeg)) {
      if (in.corrupt()) return 2;
      continue;
    }
    while (true) {
      if (cend != 0 && in.vtell() >= cend) break;
      int32_t bs;
      if (!in.read(&bs, 4)) {
        if (in.corrupt()) return 2;
        done = true;
        break;
      }
      if (bs <= 0 || bs > (1 << 27)) return 2;
      rec.resize(bs);
      if (!in.read(rec.data(), bs)) return 2;
      int32_t r_rid, r_pos;
      memcpy(&r_rid, rec.data(), 4);
      memcpy(&r_pos, rec.data() + 4, 4);
      if (r_rid != want_rid) {
        if (cend == 0 && r_rid > want_rid) { done = true; break; }
        continue;
      }
      if (r_pos >= end) {
        if (cend == 0) { done = true; break; }
        break;
      }
      uint16_t flag;
      memcpy(&flag, rec.data() + 14, 2);
      if (flag & FUNMAP) continue;
      uint8_t l_read_name = rec[8];
      uint16_t n_cigar;
      memcpy(&n_cigar, rec.data() + 12, 2);
      int32_t l_seq;
      memcpy(&l_seq, rec.data() + 16, 4);
      // reference end from cigar
      int64_t ref_len = 0;
      const uint8_t* cig = rec.data() + 32 + l_read_name;
      for (int k = 0; k < n_cigar; k++) {
        uint32_t v;
        memcpy(&v, cig + 4 * k, 4);
        uint32_t op = v & 0xf;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
          ref_len += v >> 4;
      }
      int64_t ref_end = r_pos + ref_len;
      if (ref_end <= start) continue;
      if (ref_end == r_pos) ref_end = r_pos + 1;

      // tag lookup by qname
      std::string qn(reinterpret_cast<const char*>(rec.data() + 32),
                     size_t(l_read_name) - 1);
      auto it = std::lower_bound(
          tag_list.begin(), tag_list.end(), qn,
          [](const std::pair<std::string, int>& a, const std::string& b) {
            return a.first < b;
          });
      int ti = (it != tag_list.end() && it->first == qn) ? it->second : -1;

      size_t tag_start = 32 + size_t(l_read_name) + size_t(n_cigar) * 4 +
                         size_t((l_seq + 1) / 2) + size_t(l_seq);
      if (tag_start > rec.size()) continue;  // malformed

      edited.assign(rec.begin(), rec.begin() + tag_start);
      // recomputed bin, like BamWriter.write (io/bam.py:426)
      int32_t bin = hbin(r_pos, ref_end);
      edited[10] = uint8_t(bin);
      edited[11] = uint8_t(bin >> 8);
      // copy tags, dropping HP/PS when we are retagging this read
      const uint8_t* p = rec.data() + tag_start;
      const uint8_t* tend = rec.data() + rec.size();
      while (p + 3 <= tend) {
        char t0 = char(p[0]), t1 = char(p[1]), typ = char(p[2]);
        size_t vsz = tag_value_size(typ, p + 3, tend);
        size_t total = 3 + vsz;
        if (p + total > tend) total = tend - p;
        bool drop = ti >= 0 && ((t0 == 'H' && t1 == 'P') ||
                                (t0 == 'P' && t1 == 'S'));
        if (!drop) edited.insert(edited.end(), p, p + total);
        p += total;
      }
      if (ti >= 0) {
        int8_t hp = tag_hp[ti];
        edited.push_back('H'); edited.push_back('P');
        edited.push_back('c'); edited.push_back(uint8_t(hp));
        int64_t ps = tag_ps[ti];
        edited.push_back('P'); edited.push_back('S');
        if (ps >= -128 && ps < 128) {
          edited.push_back('c'); edited.push_back(uint8_t(ps));
        } else if (ps >= -32768 && ps < 32768) {
          edited.push_back('s');
          edited.push_back(uint8_t(ps)); edited.push_back(uint8_t(ps >> 8));
        } else {
          edited.push_back('i');
          put_i32(&edited, int32_t(ps));
        }
      }

      size_t off_beg = out.offset();
      int32_t new_size = int32_t(edited.size());
      out.write(reinterpret_cast<uint8_t*>(&new_size), 4);
      out.write(edited.data(), edited.size());
      recs_meta.push_back({bin, r_pos, ref_end, off_beg, out.offset()});
    }
  }
  if (!out.finish()) return 1;

  // BAI (same layout as io/bam.py BamWriter._write_bai)
  std::vector<std::pair<int32_t, std::pair<uint64_t, uint64_t>>> bin_chunks;
  std::vector<uint64_t> linear;  // 16kb windows → min voff
  bin_chunks.reserve(recs_meta.size());
  for (const auto& m : recs_meta) {
    uint64_t voff_beg = out.payload_voff(m.beg);
    uint64_t voff_end = out.payload_voff(m.end);
    bin_chunks.push_back({m.bin, {voff_beg, voff_end}});
    for (int64_t win = m.pos >> 14; win <= (m.ref_end - 1) >> 14; win++) {
      if (size_t(win) >= linear.size()) linear.resize(win + 1, UINT64_MAX);
      if (voff_beg < linear[win]) linear[win] = voff_beg;
    }
  }
  std::sort(bin_chunks.begin(), bin_chunks.end());
  std::vector<uint8_t> bai;
  bai.push_back('B'); bai.push_back('A'); bai.push_back('I'); bai.push_back(1);
  put_i32(&bai, n_ref);
  for (int32_t r = 0; r < n_ref; r++) {
    if (r != want_rid || bin_chunks.empty()) {
      put_i32(&bai, 0);  // n_bin
      put_i32(&bai, 0);  // n_intv
      continue;
    }
    // group by bin, merging overlapping/adjacent chunks
    std::vector<std::pair<int32_t, std::vector<std::pair<uint64_t, uint64_t>>>>
        bins;
    for (auto& bc : bin_chunks) {
      if (bins.empty() || bins.back().first != bc.first)
        bins.push_back({bc.first, {}});
      auto& lst = bins.back().second;
      if (!lst.empty() && bc.second.first <= lst.back().second)
        lst.back().second = std::max(lst.back().second, bc.second.second);
      else
        lst.push_back(bc.second);
    }
    put_i32(&bai, int32_t(bins.size()));
    for (auto& b : bins) {
      put_i32(&bai, b.first);
      put_i32(&bai, int32_t(b.second.size()));
      for (auto& ch : b.second) {
        put_u64(&bai, ch.first);
        put_u64(&bai, ch.second);
      }
    }
    put_i32(&bai, int32_t(linear.size()));
    uint64_t prev = 0;
    for (uint64_t v : linear) {
      if (v == UINT64_MAX) v = prev;
      prev = v;
      put_u64(&bai, v);
    }
  }
  std::string bai_path = std::string(out_path) + ".bai";
  FILE* bf = fopen(bai_path.c_str(), "wb");
  if (!bf) return 1;
  fwrite(bai.data(), 1, bai.size(), bf);
  fclose(bf);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact weighted-MEC phasing DP with joint genotype re-typing (the
// whatshap fixed-parameter trellis, Patterson et al. 2015; reference
// runs whatshap at indelCaller.py:228,238). Native twin of the Python
// DP in phase/wmec.py::wmec_exact_gt — bit-for-bit identical decisions
// (same state-bit layout, tie rules and double arithmetic) but with
// O(2^A) column costs via subset-sum deltas instead of O(obs × 2^A)
// numpy broadcasts, and no per-column Python overhead: whole-contig
// blocks that cost ~60 s in Python run in well under a second.
// Observations carry unit weight; gq is the genotype-change penalty in
// observation units (pass something huge to pin genotypes = plain wMEC).
// ---------------------------------------------------------------------------

extern "C" {

// Greedy whatshap-style coverage selection (phase/wmec.select_reads
// hot loop): visit reads in the given priority order; take a read iff
// every column of its [first, last] site span currently has fewer than
// max_cov active selected reads. Bit-identical to the Python loop by
// construction (same order, same predicate).
void ncio_select_greedy(const int64_t* order, int64_t n_order,
                        const int64_t* first, const int64_t* last,
                        int64_t S, int32_t max_cov, uint8_t* taken) {
  std::vector<int32_t> active(size_t(S), 0);
  for (int64_t i = 0; i < n_order; i++) {
    const int64_t r = order[i];
    int64_t f = first[r], l = last[r] + 1;
    if (f < 0) f = 0;
    if (l > S) l = S;
    int32_t mx = 0;
    for (int64_t j = f; j < l; j++)
      if (active[j] > mx) mx = active[j];
    if (mx < max_cov) {
      for (int64_t j = f; j < l; j++) active[j]++;
      taken[r] = 1;
    }
  }
}

// Connectivity-first whatshap-style selection
// (phase/wmec.select_reads_connectivity hot loop): lazy-rescoring heap
// over multi-site reads, score = number of still-unlinked ADJACENT site
// pairs in the read's span, ties by (#obs, span, -rid). Bit-identical
// to the Python heapq loop by construction: the key order is a strict
// total order (rid unique), so both always pop the same element.
void ncio_select_connectivity(const int64_t* first, const int64_t* last,
                              const int64_t* cnt, const int64_t* multi,
                              int64_t n_multi, int64_t S, int32_t max_cov,
                              uint8_t* taken) {
  std::vector<int32_t> active(size_t(S), 0);
  std::vector<int32_t> link(size_t(S > 1 ? S - 1 : 1), 0);
  struct Ent {
    int64_t nsc, ncnt, nspan, r;  // negated keys, python-tuple order
  };
  auto after = [](const Ent& a, const Ent& b) {
    // std::priority_queue pops the comp-maximum; return true when a is
    // tuple-GREATER than b so the top is the tuple-minimum (heapq pop)
    if (a.nsc != b.nsc) return a.nsc > b.nsc;
    if (a.ncnt != b.ncnt) return a.ncnt > b.ncnt;
    if (a.nspan != b.nspan) return a.nspan > b.nspan;
    return a.r > b.r;
  };
  std::priority_queue<Ent, std::vector<Ent>, decltype(after)> heap(after);
  auto score = [&](int64_t r) -> int64_t {
    int64_t f = first[r], l = last[r];
    if (l <= f) return 0;
    int64_t s = 0;
    for (int64_t j = f; j < l; j++) s += (link[j] == 0);
    return s;
  };
  for (int64_t k = 0; k < n_multi; k++) {
    const int64_t r = multi[k];
    heap.push({-score(r), -cnt[r], -(last[r] - first[r]), r});
  }
  while (!heap.empty()) {
    Ent e = heap.top();
    heap.pop();
    const int64_t cur = score(e.r);
    if (-e.nsc != cur) {
      heap.push({-cur, e.ncnt, e.nspan, e.r});
      continue;
    }
    const int64_t f = first[e.r], l = last[e.r] + 1;
    int32_t mx = 0;
    for (int64_t j = f; j < l; j++)
      if (active[j] > mx) mx = active[j];
    if (mx < max_cov) {
      for (int64_t j = f; j < l; j++) active[j]++;
      for (int64_t j = f; j < l - 1; j++) link[j]++;
      taken[e.r] = 1;
    }
  }
}

// returns 0 on success; -1 infeasible (active width > max_active or
// trellis cells > cell_budget). Outputs: a1/a2 (alleles on hap1/hap2
// per site), part (side 0/1 per read), cost.
int32_t ncio_wmec(int32_t n_sites, int32_t n_reads,
                  const int32_t* first, const int32_t* last,
                  const int64_t* col_start,  // n_sites+1 CSR by site
                  const int32_t* obs_read, const int8_t* obs_allele,
                  const int8_t* g_in, double gq,
                  int32_t max_active, int64_t cell_budget,
                  int8_t* a1, int8_t* a2, int8_t* part, double* cost_out) {
  if (max_active > 24) return -1;
  // per-column active read lists (ascending id) via incremental sweep
  std::vector<std::vector<int32_t>> starts(n_sites);
  for (int32_t r = 0; r < n_reads; ++r)
    if (first[r] >= 0 && first[r] < n_sites) starts[first[r]].push_back(r);
  std::vector<std::vector<int32_t>> active_at(n_sites);
  {
    std::vector<int32_t> active;
    for (int32_t j = 0; j < n_sites; ++j) {
      for (int32_t r : starts[j]) active.push_back(r);
      std::sort(active.begin(), active.end());
      active.erase(std::remove_if(active.begin(), active.end(),
                                  [&](int32_t r) { return last[r] < j; }),
                   active.end());
      if ((int32_t)active.size() > max_active) return -1;
      active_at[j] = active;
    }
  }
  std::vector<int64_t> col_off(n_sites + 1, 0);
  for (int32_t j = 0; j < n_sites; ++j)
    col_off[j + 1] = col_off[j] + (1LL << active_at[j].size());
  const int64_t total_cells = col_off[n_sites];
  // cell_budget bounds the parent/gt STORE; blocks up to 16x run in
  // checkpoint mode (frontier snapshots + per-block recompute at 2x
  // forward cost) so cap 15 survives whole-contig block sizes
  const bool checkpoint = total_cells > cell_budget;
  if (total_cells > 16 * cell_budget) return -1;

  // per-column shared-bit plan vs the previous column
  std::vector<std::vector<int32_t>> sh_prev_at(n_sites), sh_cur_at(n_sites);
  {
    std::vector<int32_t> bitpos(n_reads, -1);
    std::vector<int32_t> prev;
    for (int32_t j = 0; j < n_sites; ++j) {
      const std::vector<int32_t>& active = active_at[j];
      for (int32_t i = 0; i < (int32_t)active.size(); ++i) {
        int32_t pb = bitpos[active[i]];
        if (pb >= 0) {
          sh_prev_at[j].push_back(pb);
          sh_cur_at[j].push_back(i);
        }
      }
      for (int32_t r : prev) bitpos[r] = -1;
      for (int32_t i = 0; i < (int32_t)active.size(); ++i)
        bitpos[active[i]] = i;
      prev = active;
    }
  }

  // scratch reused across columns
  std::vector<double> fold_c, o0, base_c;
  std::vector<int64_t> fold_m;
  std::vector<uint32_t> fold_m32, base_m;
  std::vector<char> is_sh;
  std::vector<double> alt_w(max_active), ref_w(max_active),
      delta(max_active);

  // one column: prev_dp/prev_A -> dp (in `dp_out`); writes parent (the
  // PREVIOUS column's best mask per current mask) and (g<<1)|ori into
  // par/go when non-null. Exactly the Python DP's per-element
  // arithmetic and tie rules:
  //  - best over hidden prev bits: min, ties -> LARGEST prev mask
  //    (np.maximum.at over argmin hits);
  //  - column costs are exact small-integer doubles (order-free sums);
  //  - genotype: input g first, strict < with +gq to switch;
  //  - ori = (o1 < o0).
  auto step = [&](int32_t j, const std::vector<double>& prev_dp,
                  int32_t prev_A, std::vector<double>& dp_out,
                  uint32_t* par, int8_t* go) {
    const std::vector<int32_t>& active = active_at[j];
    const int32_t A = (int32_t)active.size();
    const int64_t M = 1LL << A;
    const std::vector<int32_t>& sh_prev = sh_prev_at[j];
    const std::vector<int32_t>& sh_cur = sh_cur_at[j];
    const int32_t nsh = (int32_t)sh_prev.size();

    // fast path: unchanged active set (no reads start or end) — the
    // shared map is the identity, so best==prev_dp and parent==m
    bool same_set = (nsh == A) && (prev_A == A);
    if (same_set)
      for (int32_t k = 0; k < nsh; ++k)
        if (sh_prev[k] != k || sh_cur[k] != k) { same_set = false; break; }

    // best_cost/best_mask over the shared key: fold the hidden
    // (non-shared) prev bits out of prev_dp, high bit first — each
    // fold is a contiguous block-min the compiler vectorizes. The
    // surviving index is the shared bits compacted in ascending
    // position order == the rank order both sh lists use.
    const int64_t PM = 1LL << prev_A;
    if (!same_set) {
    fold_c.assign(prev_dp.begin(), prev_dp.end());
    fold_m.resize(PM);
    for (int64_t m = 0; m < PM; ++m) fold_m[m] = m;
    is_sh.assign(prev_A, 0);
    for (int32_t p : sh_prev) is_sh[p] = 1;
    int64_t size = PM;
    for (int32_t p = prev_A - 1; p >= 0; --p) {
      if (is_sh[p]) continue;
      const int64_t half = 1LL << p;
      const int64_t blocks = size >> (p + 1);
      double* c = fold_c.data();
      int64_t* mk = fold_m.data();
      int64_t w = 0;
      for (int64_t b = 0; b < blocks; ++b) {
        const int64_t lo = b << (p + 1);
        for (int64_t t = 0; t < half; ++t) {
          const double c1 = c[lo + t], c2 = c[lo + half + t];
          const int64_t m1 = mk[lo + t], m2 = mk[lo + half + t];
          const bool take2 = (c2 < c1) || (c2 == c1 && m2 > m1);
          c[w + t] = take2 ? c2 : c1;
          mk[w + t] = take2 ? m2 : m1;
        }
        w += half;
      }
      size >>= 1;
    }
    }  // fold_c/fold_m[0 .. 2^nsh) now hold the reduction

    // column cost pieces
    for (int32_t i = 0; i < A; ++i) alt_w[i] = ref_w[i] = 0.0;
    {
      // bit index per active read via a small local map
      int32_t lp[32];
      for (int32_t i = 0; i < A; ++i) lp[i] = active[i];
      for (int64_t o = col_start[j]; o < col_start[j + 1]; ++o) {
        const int32_t r = obs_read[o];
        int32_t i = -1;
        for (int32_t t = 0; t < A; ++t)
          if (lp[t] == r) { i = t; break; }
        if (i < 0) continue;  // single-obs read, not a state bit
        if (obs_allele[o]) alt_w[i] += 1.0; else ref_w[i] += 1.0;
      }
    }
    double base = 0.0, tot = 0.0;
    for (int32_t i = 0; i < A; ++i) {
      base += alt_w[i];
      tot += alt_w[i] + ref_w[i];
      delta[i] = ref_w[i] - alt_w[i];
    }
    // o0 by doubling (contiguous add-constant copies; values are exact
    // integer doubles, so the add order cannot change them)
    o0.resize(M);
    o0[0] = base;
    for (int32_t b = 0; b < A; ++b) {
      const int64_t h = 1LL << b;
      const double d = delta[b];
      const double* src = o0.data();
      double* dst = o0.data() + h;
      for (int64_t m = 0; m < h; ++m) dst[m] = src[m] + d;
    }
    // expand best_cost/best_mask over the current mask space:
    // base[m] = fold[compact(m onto sh_cur)]. Shared ranks ascend with
    // bit position, so any all-shared low region is a CONTIGUOUS fold
    // slice and non-shared bits duplicate blocks — the whole expansion
    // is memcpys (no per-element gather).
    if (!same_set) {
    base_c.resize(M);
    base_m.resize(M);
    fold_m32.resize(1LL << nsh);
    for (int64_t k = 0; k < (1LL << nsh); ++k)
      fold_m32[k] = (uint32_t)fold_m[k];
    {
      int32_t rank_of[32];
      char all_sh_below[33];
      for (int32_t i = 0; i < A; ++i) rank_of[i] = -1;
      for (int32_t k = 0; k < nsh; ++k) rank_of[sh_cur[k]] = k;
      all_sh_below[0] = 1;
      for (int32_t i = 0; i < A; ++i)
        all_sh_below[i + 1] = all_sh_below[i] && (rank_of[i] >= 0);
      struct Ctx {
        const double* bc;
        const uint32_t* bm;
        double* dc;
        uint32_t* dm;
        const int32_t* rank_of;
        const char* all_sh;
      } ctx{fold_c.data(), fold_m32.data(), base_c.data(), base_m.data(),
            rank_of, all_sh_below};
      struct Rec {
        static void fill(const Ctx& c, int32_t nbits, int64_t o,
                         int64_t dst) {
          if (c.all_sh[nbits]) {  // bits [0, nbits) all shared: ranks
            const int64_t n = 1LL << nbits;  // are 0..nbits-1 -> slice
            memcpy(c.dc + dst, c.bc + o, n * sizeof(double));
            memcpy(c.dm + dst, c.bm + o, n * sizeof(uint32_t));
            return;
          }
          const int32_t b = nbits - 1;
          const int64_t h = 1LL << b;
          fill(c, b, o, dst);
          if (c.rank_of[b] < 0) {
            memcpy(c.dc + dst + h, c.dc + dst, h * sizeof(double));
            memcpy(c.dm + dst + h, c.dm + dst, h * sizeof(uint32_t));
          } else {
            fill(c, b, o + (1LL << c.rank_of[b]), dst + h);
          }
        }
      };
      Rec::fill(ctx, A, 0, 0);
    }
    }  // !same_set
    // per-mask column cost + genotype/orientation, fused with the dp
    // update (every M-sized pass is memory-bound at cap 15)
    const int32_t gj = g_in[j];
    const double cost_g0 = base, cost_g2 = tot - base;
    const bool pinned = gq > 1e29;  // common exact_refine case
    dp_out.resize(M);
    const double* basesrc = same_set ? prev_dp.data() : base_c.data();
    double* dpp = dp_out.data();
    const double* o0p = o0.data();
    if (pinned && gj == 1) {
      if (go) {
        for (int64_t m = 0; m < M; ++m) {
          const double v0 = o0p[m], v1 = tot - v0;
          const bool ori = v1 < v0;
          dpp[m] = basesrc[m] + (ori ? v1 : v0);
          go[m] = (int8_t)(2 | (ori ? 1 : 0));
        }
      } else {
        for (int64_t m = 0; m < M; ++m) {
          const double v0 = o0p[m], v1 = tot - v0;
          dpp[m] = basesrc[m] + (v1 < v0 ? v1 : v0);
        }
      }
    } else {
      for (int64_t m = 0; m < M; ++m) {
        const double v0 = o0p[m], v1 = tot - v0;
        const int8_t ori = (v1 < v0) ? 1 : 0;
        const double c1 = ori ? v1 : v0;
        const double cost_by_g[3] = {cost_g0, c1, cost_g2};
        double best = cost_by_g[gj];
        int8_t g = (int8_t)gj;
        for (int32_t cand = 0; cand < 3; ++cand) {
          if (cand == gj) continue;
          const double c = cost_by_g[cand] + gq;
          if (c < best) { best = c; g = (int8_t)cand; }
        }
        dpp[m] = basesrc[m] + best;
        if (go) go[m] = (int8_t)((g << 1) | ori);
      }
    }
    if (par) {
      if (same_set) {
        for (int64_t m = 0; m < M; ++m) par[m] = (uint32_t)m;
      } else {
        memcpy(par, base_m.data(), M * sizeof(uint32_t));
      }
    }
  };

  auto backtrace_span = [&](int32_t jb, int32_t je, int64_t& mask,
                            const uint32_t* parent, const int8_t* gt_ori,
                            int64_t off0) {
    // walk columns [jb, je) downward; arrays indexed from col_off[jb]
    for (int32_t j = je - 1; j >= jb; --j) {
      const std::vector<int32_t>& active = active_at[j];
      for (int32_t i = 0; i < (int32_t)active.size(); ++i)
        part[active[i]] = (int8_t)((mask >> i) & 1);
      const int64_t c = col_off[j] - off0 + mask;
      const int8_t go = gt_ori[c];
      const int8_t g = go >> 1, ori = go & 1;
      if (g == 1) { a1[j] = ori; a2[j] = (int8_t)(1 - ori); }
      else { a1[j] = a2[j] = (g == 2) ? 1 : 0; }
      mask = parent[c];
    }
  };

  std::vector<double> prev_dp(1, 0.0), dp;
  if (!checkpoint) {
    std::vector<uint32_t> parent(total_cells);
    std::vector<int8_t> gt_ori(total_cells);
    int32_t prev_A = 0;
    for (int32_t j = 0; j < n_sites; ++j) {
      step(j, prev_dp, prev_A, dp, &parent[col_off[j]], &gt_ori[col_off[j]]);
      prev_A = (int32_t)active_at[j].size();
      prev_dp.swap(dp);
    }
    int64_t mask = 0;
    double best = std::numeric_limits<double>::infinity();
    for (int64_t m = 0; m < (int64_t)prev_dp.size(); ++m)
      if (prev_dp[m] < best) { best = prev_dp[m]; mask = m; }
    *cost_out = best;
    backtrace_span(0, n_sites, mask, parent.data(), gt_ori.data(), 0);
    return 0;
  }

  // ---- checkpoint mode: frontier snapshots + per-block recompute ----
  // block boundaries: greedy cuts keeping each block's cells <= budget
  std::vector<int32_t> cuts(1, 0);
  {
    int64_t acc = 0;
    for (int32_t j = 0; j < n_sites; ++j) {
      const int64_t cells = 1LL << active_at[j].size();
      if (acc + cells > cell_budget && acc > 0) {
        cuts.push_back(j);
        acc = 0;
      }
      acc += cells;
    }
    cuts.push_back(n_sites);
  }
  const int32_t n_blocks = (int32_t)cuts.size() - 1;
  std::vector<std::vector<double>> frontiers(n_blocks);
  {
    int32_t prev_A = 0, blk = 0;
    for (int32_t j = 0; j < n_sites; ++j) {
      if (blk < n_blocks && j == cuts[blk]) frontiers[blk++] = prev_dp;
      step(j, prev_dp, prev_A, dp, nullptr, nullptr);
      prev_A = (int32_t)active_at[j].size();
      prev_dp.swap(dp);
    }
  }
  int64_t mask = 0;
  double best = std::numeric_limits<double>::infinity();
  for (int64_t m = 0; m < (int64_t)prev_dp.size(); ++m)
    if (prev_dp[m] < best) { best = prev_dp[m]; mask = m; }
  *cost_out = best;
  std::vector<uint32_t> parent;
  std::vector<int8_t> gt_ori;
  for (int32_t blk = n_blocks - 1; blk >= 0; --blk) {
    const int32_t jb = cuts[blk], je = cuts[blk + 1];
    const int64_t off0 = col_off[jb];
    const int64_t cells = col_off[je] - off0;
    parent.resize(cells);
    gt_ori.resize(cells);
    std::vector<double> fdp = frontiers[blk];
    int32_t prev_A = jb == 0 ? 0 : (int32_t)active_at[jb - 1].size();
    for (int32_t j = jb; j < je; ++j) {
      step(j, fdp, prev_A, dp, &parent[col_off[j] - off0],
           &gt_ori[col_off[j] - off0]);
      prev_A = (int32_t)active_at[j].size();
      fdp.swap(dp);
    }
    backtrace_span(jb, je, mask, parent.data(), gt_ori.data(), off0);
  }
  return 0;
}

}  // extern "C"
