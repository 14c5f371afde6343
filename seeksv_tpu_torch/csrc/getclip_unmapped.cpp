// getclip's pairing of unmapped mates (io/native.py, UnmappedPairer;
// pipeline/getclip.py, GetclipStream).
//
// StoreUnmapSeqAndQual (ref: clip_reads.h:172-219) over one slab's
// records at a time, as pipeline/getclip.py:_store_unmapped does it one
// record at a time.  A handle carries the mates still unpaired from slab
// to slab, keyed by qname:
//
//   - a record's end is 1 when it has READ1 (0x40), else 2, so a record
//     with neither flag is end 2;
//   - the first record of a name is kept; a later one of the same name
//     and the other end completes the pair: its READ1 side goes to un1 as
//     "@name/1", the other to un2 as "@name/2", and the entry goes; a later
//     one of the same end writes nothing and leaves the first;
//   - the quality is "*" when its first byte is 0xFF, else each byte
//     +33; an empty read writes empty lines;
//   - what is still unpaired when the handle is freed is dropped.
//
// Each call returns the FASTQ text of the pairs it completed, in the
// order it completed them, as two buffers that the handle owns and that
// stay valid until its next call.
//
// Built into the same library as csrc/seeksv_native.cpp
// (seeksv_tpu_torch/_build.py:build_native), with the same flags.

#include <cstdint>
#include <string>
#include <unordered_map>

namespace {

constexpr int32_t kRead1 = 0x40;

struct Mate {
  std::string seq, qual;
  bool read1;
};

struct Pairer {
  std::unordered_map<std::string, Mate> open;
  std::string un1, un2;
};

void put_qual(std::string& out, const uint8_t* q, int64_t n) {
  if (n > 0 && q[0] == 0xFF) {
    out += '*';
    return;
  }
  const size_t at = out.size();
  out.resize(at + (size_t)n);
  for (int64_t k = 0; k < n; k++) out[at + k] = (char)(uint8_t)(q[k] + 33);
}

void put_record(std::string& out, const std::string& name, char end,
                const std::string& seq, const std::string& qual) {
  out += '@';
  out += name;
  out += '/';
  out += end;
  out += '\n';
  out += seq;
  out += "\n+\n";
  out += qual;
  out += '\n';
}

}  // namespace

extern "C" {

void* seeksv_torch_unmapped_new() { return new Pairer(); }

void seeksv_torch_unmapped_free(void* hp) { delete (Pairer*)hp; }

// Pairs the records idx[0..n_idx) of one slab, in that order: flag, and
// the ASCII bases / raw qualities at seq[seq_off[r]:seq_off[r+1]], the
// name at qnames[qname_off[r]:qname_off[r+1]].  Returns the pairs
// completed; *un1 / *un2 point at their text (*un1_len / *un2_len bytes).
int64_t seeksv_torch_unmapped_pair(
    void* hp, const int32_t* flag, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off, const uint8_t* qnames, const int64_t* qname_off,
    const int64_t* idx, int64_t n_idx, const char** un1, int64_t* un1_len,
    const char** un2, int64_t* un2_len) {
  Pairer* h = (Pairer*)hp;
  h->un1.clear();
  h->un2.clear();
  int64_t pairs = 0;
  std::string name, s, q;
  for (int64_t j = 0; j < n_idx; j++) {
    const int64_t r = idx[j];
    const bool read1 = (flag[r] & kRead1) != 0;
    name.assign((const char*)qnames + qname_off[r],
                (size_t)(qname_off[r + 1] - qname_off[r]));
    const int64_t base = seq_off[r];
    const int64_t len = seq_off[r + 1] - base;
    auto it = h->open.find(name);
    if (it == h->open.end()) {
      Mate& m = h->open[name];
      m.seq.assign((const char*)seq + base, (size_t)len);
      put_qual(m.qual, qual + base, len);
      m.read1 = read1;
      continue;
    }
    const Mate& m = it->second;
    if (m.read1 == read1) continue;  // the same end again: keep the first
    s.assign((const char*)seq + base, (size_t)len);
    q.clear();
    put_qual(q, qual + base, len);
    const std::string& s1 = read1 ? s : m.seq;
    const std::string& q1 = read1 ? q : m.qual;
    const std::string& s2 = read1 ? m.seq : s;
    const std::string& q2 = read1 ? m.qual : q;
    put_record(h->un1, name, '1', s1, q1);
    put_record(h->un2, name, '2', s2, q2);
    h->open.erase(it);
    pairs++;
  }
  *un1 = h->un1.data();
  *un1_len = (int64_t)h->un1.size();
  *un2 = h->un2.data();
  *un2_len = (int64_t)h->un2.size();
  return pairs;
}

}  // extern "C"
