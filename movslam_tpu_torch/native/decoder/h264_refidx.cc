// h264_refidx: recover per-block L0 reference indices from H.264 CAVLC
// bitstreams with STOCK libavcodec.
//
// The reference framework gets the reference-frame index of each motion
// vector by patching FFmpeg (the C++ reference's ffmpeg-ref-patch.patch:122-129
// adds `int32_t ref` to AVMotionVector, populated from the decoder's
// per-8x8-block ref_index array). No patched libavcodec exists in this
// image, so this parser recovers the same information from the bitstream
// itself: it performs a full syntax parse of CAVLC P-slice data (ITU-T
// H.264 sections 7.3.4/7.3.5 + 9.1/9.2) — macroblock types, sub-macroblock
// partitions, ref_idx_l0, motion vector differences, coded block patterns
// and the complete CAVLC residual layer (coeff_token with nC neighbour
// contexts, levels, total_zeros, run_before) — because ref_idx_l0 sits in
// the middle of the entropy-coded slice payload and every bit before the
// next macroblock must be consumed exactly.
//
// Output granularity matches the patch's export: one reference index per
// 8x8 luma block (AVMotionVector export emits at most one vector per 8x8
// block; mpegutils.c add_mb in the patch reads ref_index[dir][4*mb_xy+i]).
// The stored value is `frames_back - 1` (the hop count the decomposition in
// mv_decoder.cc divides by), computed from the slice's actual reference
// picture list — frame_num arithmetic plus ref_pic_list_modification — so
// it stays correct even if the encoder reorders list0 (the reference's
// patched export would break there; x264 doesn't reorder by default).
//
// Scope (= the reference's published operating point, README.md:47-69):
// progressive frame_mbs_only CAVLC 4:2:0 8-bit streams, P slices with any
// partition mix (16x16..4x4), multi-ref (ref=1..16), weighted prediction
// headers, multiple slices per frame. Unsupported features (CABAC, fields/
// MBAFF, slice groups, long-term refs, SP/SI) cleanly disable the parser —
// the decoder then falls back to ref=0 exactly as before.
//
// VLC tables come from h264_cavlc_tables.h (normative spec constants,
// extracted + validated by tools/extract_cavlc_tables.py).

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <vector>

#include "h264_cavlc_tables.h"

namespace {

using namespace h264cavlc;

// ---------------------------------------------------------------------------
// RBSP bit reader (emulation-prevention bytes already stripped).
struct Bits {
  const uint8_t* d = nullptr;
  size_t n = 0;          // bytes
  size_t pos = 0;        // bit position
  size_t stop = 0;       // bit position of the rbsp_stop_one_bit
  bool err = false;

  void init(const uint8_t* data, size_t size) {
    d = data;
    n = size;
    pos = 0;
    err = false;
    // rbsp_stop_one_bit: the last set bit in the buffer.
    stop = 0;
    for (size_t i = size; i-- > 0;) {
      if (d[i]) {
        uint8_t b = d[i];
        int lowest = 0;
        while (!((b >> lowest) & 1)) ++lowest;
        stop = i * 8 + (7 - lowest);
        break;
      }
    }
  }
  bool more_rbsp_data() const { return !err && pos < stop; }
  uint32_t u(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      size_t byte = pos >> 3;
      if (byte >= n) {
        err = true;
        return 0;
      }
      v = (v << 1) | ((d[byte] >> (7 - (pos & 7))) & 1);
      ++pos;
    }
    return v;
  }
  uint32_t peek(int bits) {
    size_t save = pos;
    bool e = err;
    uint32_t v = u(bits);
    pos = save;
    err = e;
    return v;
  }
  uint32_t ue() {
    int zeros = 0;
    while (true) {
      size_t byte = pos >> 3;
      if (byte >= n) {
        err = true;
        return 0;
      }
      if ((d[byte] >> (7 - (pos & 7))) & 1) break;
      ++pos;
      if (++zeros > 31) {
        err = true;
        return 0;
      }
    }
    ++pos;  // the terminating 1
    return (1u << zeros) - 1 + u(zeros);
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
  }
  uint32_t te(int range) {  // truncated exp-golomb
    if (range == 1) return u(1) ^ 1;
    return ue();
  }
  void align() { pos = (pos + 7) & ~(size_t)7; }
  void skip_bytes(size_t k) { pos += 8 * k; if (pos > 8 * n) err = true; }
};

// ---------------------------------------------------------------------------
// VLC lookup built from (len, bits) spec tables.
struct Vlc {
  int max_len = 0;
  std::vector<uint16_t> lut;  // (symbol << 5) | len; 0 = invalid

  void build(const uint8_t* lens, const uint8_t* bits, int count,
             const uint8_t* valid /*may be null*/) {
    max_len = 0;
    for (int i = 0; i < count; ++i)
      if ((!valid || valid[i]) && lens[i] > max_len) max_len = lens[i];
    lut.assign((size_t)1 << max_len, 0);
    for (int i = 0; i < count; ++i) {
      if (valid && !valid[i]) continue;
      int L = lens[i];
      if (L == 0) continue;
      uint32_t base = (uint32_t)bits[i] << (max_len - L);
      for (uint32_t k = 0; k < (1u << (max_len - L)); ++k)
        lut[base + k] = (uint16_t)((i << 5) | L);
    }
  }
  // Returns symbol index or -1 on invalid code.
  int get(Bits& b) const {
    // peek may run past the buffer near the end: pad by reading what's left.
    int avail = (int)(8 * b.n - b.pos);
    if (avail <= 0) {
      b.err = true;
      return -1;
    }
    int w = max_len <= avail ? max_len : avail;
    uint32_t code = b.peek(w) << (max_len - w);
    uint16_t e = lut[code];
    if (!e || (int)(e & 31) > avail) {
      b.err = true;
      return -1;
    }
    b.pos += e & 31;
    return e >> 5;
  }
};

// coeff_token tables: 68 entries = 17 total_coeff rows x 4 trailing_ones.
static uint8_t kCoeffTokenValid[68];
static uint8_t kChromaDcValid[20];

struct Tables {
  Vlc coeff_token[4];  // [0,2) [2,4) [4,8) nC, and the 6-bit FLC table
  Vlc chroma_dc_coeff_token;
  Vlc total_zeros[15];
  Vlc chroma_dc_total_zeros[3];
  Vlc run_before[7];
  Tables() {
    for (int tc = 0; tc < 17; ++tc)
      for (int t1 = 0; t1 < 4; ++t1)
        kCoeffTokenValid[4 * tc + t1] = t1 <= (tc < 3 ? tc : 3);
    for (int tc = 0; tc < 5; ++tc)
      for (int t1 = 0; t1 < 4; ++t1)
        kChromaDcValid[4 * tc + t1] = t1 <= (tc < 3 ? tc : 3);
    for (int t = 0; t < 4; ++t)
      coeff_token[t].build(kCoeffTokenLen[t], kCoeffTokenBits[t], 68,
                           kCoeffTokenValid);
    chroma_dc_coeff_token.build(kChromaDcCoeffTokenLen,
                                kChromaDcCoeffTokenBits, 20, kChromaDcValid);
    for (int t = 0; t < 15; ++t) {
      uint8_t valid[16] = {0};
      for (int z = 0; z <= 16 - (t + 1); ++z) valid[z] = 1;
      total_zeros[t].build(kTotalZerosLen[t], kTotalZerosBits[t], 16, valid);
    }
    for (int t = 0; t < 3; ++t) {
      uint8_t valid[4] = {0};
      for (int z = 0; z <= 3 - t; ++z) valid[z] = 1;
      chroma_dc_total_zeros[t].build(kChromaDcTotalZerosLen[t],
                                     kChromaDcTotalZerosBits[t], 4, valid);
    }
    for (int t = 0; t < 7; ++t) {
      int nvalid = (t == 6) ? 15 : t + 2;
      uint8_t valid[16] = {0};
      for (int z = 0; z < nvalid; ++z) valid[z] = 1;
      run_before[t].build(kRunLen[t], kRunBits[t], 16, valid);
    }
  }
};
static const Tables& tables() {
  static Tables t;
  return t;
}

// ---------------------------------------------------------------------------
struct Sps {
  int id = -1;
  int log2_max_frame_num = 4;
  int poc_type = 0;
  int log2_max_poc_lsb = 4;
  int delta_pic_order_always_zero = 0;
  int num_ref_frames_in_poc_cycle = 0;
  int max_num_ref_frames = 1;
  int mb_w = 0, mb_h = 0;
  int frame_mbs_only = 1;
  int chroma_format_idc = 1;
  bool ok = false;
};

struct Pps {
  int id = -1;
  int sps_id = 0;
  int entropy_coding_mode = 0;
  int pic_order_present = 0;
  int num_ref_idx_l0_default = 1;
  int num_ref_idx_l1_default = 1;
  int weighted_pred = 0;
  int weighted_bipred_idc = 0;
  int deblocking_filter_control_present = 0;
  int redundant_pic_cnt_present = 0;
  int transform_8x8_mode = 0;
  int num_slice_groups = 1;
  bool ok = false;
};

// One frame's recovered map.
struct RefMap {
  int mb_w = 0, mb_h = 0;
  std::vector<int8_t> ref;  // mb_w*mb_h*4, hops-1 per 8x8 block, -1 intra
};

struct Parser {
  std::map<int, Sps> sps_by_id;
  std::map<int, Pps> pps_by_id;
  std::map<int64_t, RefMap> maps;
  std::vector<int> short_term_frame_nums;  // decode order, newest last
  bool disabled = false;
  int nal_length_size = 0;  // 0 = Annex-B input
  // scratch (sized on first slice)
  std::vector<uint8_t> rbsp;
  std::vector<uint8_t> nz_luma;    // (mb_w*4) x (mb_h*4) total_coeff
  std::vector<uint8_t> nz_chroma[2];  // (mb_w*2) x (mb_h*2)
  std::vector<int32_t> mb_slice;   // slice id per mb, -1 = not yet decoded
  int slice_counter = 0;

  void disable() { disabled = true; }
};

// --- per-slice parsing state ------------------------------------------------
struct Slice {
  const Sps* sps;
  const Pps* pps;
  int slice_type;  // 0 P, 1 B, 2 I (mod 5)
  int frame_num;
  int num_ref_idx_l0;
  int first_mb;
  int slice_id;
  bool is_ref;
  std::vector<int8_t> hops;  // hops-1 for each ref_idx in list0
};

// Unescape NAL payload (00 00 03 -> 00 00) into p.rbsp.
static void unescape(Parser& p, const uint8_t* d, size_t n) {
  p.rbsp.clear();
  p.rbsp.reserve(n);
  size_t zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    if (zeros >= 2 && d[i] == 3) {
      zeros = 0;
      continue;  // emulation_prevention_three_byte
    }
    zeros = d[i] == 0 ? zeros + 1 : 0;
    p.rbsp.push_back(d[i]);
  }
}

static void parse_scaling_list(Bits& b, int size) {
  int last = 8, next = 8;
  for (int j = 0; j < size; ++j) {
    if (next != 0) {
      int delta = b.se();
      next = (last + delta + 256) % 256;
    }
    last = next == 0 ? last : next;
  }
}

static void parse_sps(Parser& p, Bits& b) {
  Sps s;
  int profile = b.u(8);
  b.u(8);  // constraint flags + reserved
  b.u(8);  // level
  s.id = b.ue();
  if (profile == 100 || profile == 110 || profile == 122 || profile == 244 ||
      profile == 44 || profile == 83 || profile == 86 || profile == 118 ||
      profile == 128 || profile == 138 || profile == 139 || profile == 134) {
    s.chroma_format_idc = b.ue();
    if (s.chroma_format_idc == 3) b.u(1);  // separate_colour_plane
    b.ue();                                // bit_depth_luma_minus8
    b.ue();                                // bit_depth_chroma_minus8
    b.u(1);                                // qpprime_y_zero_transform_bypass
    if (b.u(1)) {                          // seq_scaling_matrix_present
      for (int i = 0; i < (s.chroma_format_idc != 3 ? 8 : 12); ++i)
        if (b.u(1)) parse_scaling_list(b, i < 6 ? 16 : 64);
    }
  }
  s.log2_max_frame_num = b.ue() + 4;
  s.poc_type = b.ue();
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = b.ue() + 4;
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = b.u(1);
    b.se();  // offset_for_non_ref_pic
    b.se();  // offset_for_top_to_bottom_field
    s.num_ref_frames_in_poc_cycle = b.ue();
    for (int i = 0; i < s.num_ref_frames_in_poc_cycle; ++i) b.se();
  }
  s.max_num_ref_frames = b.ue();
  b.u(1);  // gaps_in_frame_num_value_allowed
  s.mb_w = b.ue() + 1;
  s.mb_h = b.ue() + 1;
  s.frame_mbs_only = b.u(1);
  if (!s.frame_mbs_only) {
    p.disable();  // interlace/MBAFF out of scope
    return;
  }
  // direct_8x8_inference, cropping, VUI: nothing else needed.
  if (b.err) return;
  s.ok = true;
  p.sps_by_id[s.id] = s;
}

static void parse_pps(Parser& p, Bits& b) {
  Pps q;
  q.id = b.ue();
  q.sps_id = b.ue();
  q.entropy_coding_mode = b.u(1);
  q.pic_order_present = b.u(1);
  q.num_slice_groups = b.ue() + 1;
  if (q.num_slice_groups > 1) {
    p.disable();  // FMO out of scope
    return;
  }
  q.num_ref_idx_l0_default = b.ue() + 1;
  q.num_ref_idx_l1_default = b.ue() + 1;
  q.weighted_pred = b.u(1);
  q.weighted_bipred_idc = b.u(2);
  b.se();  // pic_init_qp_minus26
  b.se();  // pic_init_qs_minus26
  b.se();  // chroma_qp_index_offset
  q.deblocking_filter_control_present = b.u(1);
  b.u(1);  // constrained_intra_pred
  q.redundant_pic_cnt_present = b.u(1);
  if (b.more_rbsp_data()) {
    q.transform_8x8_mode = b.u(1);
    if (b.u(1)) {  // pic_scaling_matrix_present
      auto it = p.sps_by_id.find(q.sps_id);
      int chroma = it != p.sps_by_id.end() ? it->second.chroma_format_idc : 1;
      int count = 6 + (chroma != 3 ? 2 : 6) * q.transform_8x8_mode;
      for (int i = 0; i < count; ++i)
        if (b.u(1)) parse_scaling_list(b, i < 6 ? 16 : 64);
    }
    b.se();  // second_chroma_qp_index_offset
  }
  if (b.err) return;
  q.ok = true;
  p.pps_by_id[q.id] = q;
}

// Build list0 as hops-1 values: default order (descending PicNum) plus
// ref_pic_list_modification (8.2.4.3.1 on pic nums; long-term unsupported).
static bool build_list0(Parser& p, Bits& b, Slice& sl) {
  const int max_fn = 1 << sl.sps->log2_max_frame_num;
  // PicNum of each available short-term ref, newest first.
  std::vector<int> picnums;
  for (auto it = p.short_term_frame_nums.rbegin();
       it != p.short_term_frame_nums.rend(); ++it) {
    int fn = *it;
    picnums.push_back(fn > sl.frame_num ? fn - max_fn : fn);
  }
  // default: descending PicNum — decode order (newest first) already is.
  std::vector<int> list = picnums;

  if (sl.slice_type != 2) {  // ref_pic_list_modification_flag_l0
    if (b.u(1)) {
      int pred = sl.frame_num;
      size_t idx = 0;
      while (true) {
        uint32_t op = b.ue();
        if (op == 3) break;
        if (op == 2) {
          p.disable();  // long-term ref
          return false;
        }
        if (op > 3 || b.err) {
          p.disable();
          return false;
        }
        int diff = (int)b.ue() + 1;
        pred = op == 0 ? pred - diff : pred + diff;
        // wrap into valid PicNum range
        if (pred < 0) pred += max_fn;
        if (pred >= max_fn) pred -= max_fn;
        int picnum = pred > sl.frame_num ? pred - max_fn : pred;
        // move picnum to position idx, shifting others (8.2.4.3.1)
        std::vector<int> out;
        out.reserve(list.size() + 1);
        for (size_t i = 0; i < idx && i < list.size(); ++i)
          out.push_back(list[i]);
        out.push_back(picnum);
        for (size_t i = idx; i < list.size(); ++i)
          if (list[i] != picnum) out.push_back(list[i]);
        list = out;
        ++idx;
        if (idx > 64) {
          p.disable();
          return false;
        }
      }
    }
  }
  if ((int)list.size() < sl.num_ref_idx_l0) {
    // conforming streams guarantee enough refs; pad defensively
    while ((int)list.size() < sl.num_ref_idx_l0)
      list.push_back(list.empty() ? sl.frame_num - 1 : list.back());
  }
  sl.hops.clear();
  for (int k = 0; k < sl.num_ref_idx_l0; ++k) {
    int hops = sl.frame_num - list[k];
    if (hops < 1) hops = 1;
    int8_t v = hops - 1 > 127 ? 127 : (int8_t)(hops - 1);
    sl.hops.push_back(v);
  }
  return true;
}

// Parse the rest of the slice header after slice_type/pps_id. Returns false
// when the slice (or stream) is out of scope.
static bool parse_slice_header(Parser& p, Bits& b, Slice& sl, bool idr,
                               int nal_ref_idc) {
  const Sps& s = *sl.sps;
  const Pps& q = *sl.pps;
  sl.frame_num = b.u(s.log2_max_frame_num);
  // frame_mbs_only checked at SPS; no field_pic_flag present.
  if (idr) b.ue();  // idr_pic_id
  if (s.poc_type == 0) {
    b.u(s.log2_max_poc_lsb);
    if (q.pic_order_present) b.se();  // delta_pic_order_cnt_bottom
  } else if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
    b.se();
    if (q.pic_order_present) b.se();
  }
  if (q.redundant_pic_cnt_present) b.ue();
  if (sl.slice_type == 1) b.u(1);  // direct_spatial_mv_pred
  sl.num_ref_idx_l0 = q.num_ref_idx_l0_default;
  int num_ref_idx_l1 = q.num_ref_idx_l1_default;
  if (sl.slice_type == 0 || sl.slice_type == 1) {
    if (b.u(1)) {  // num_ref_idx_active_override
      sl.num_ref_idx_l0 = b.ue() + 1;
      if (sl.slice_type == 1) num_ref_idx_l1 = b.ue() + 1;
    }
  }
  if (sl.slice_type != 2) {
    if (!build_list0(p, b, sl)) return false;
    if (sl.slice_type == 1) {  // ref_pic_list_modification_flag_l1
      if (b.u(1)) {
        while (true) {
          uint32_t op = b.ue();
          if (op == 3) break;
          if (op == 2) {
            p.disable();
            return false;
          }
          b.ue();
          if (b.err) {
            p.disable();
            return false;
          }
        }
      }
    }
  }
  if ((q.weighted_pred && sl.slice_type == 0) ||
      (q.weighted_bipred_idc == 1 && sl.slice_type == 1)) {
    b.ue();  // luma_log2_weight_denom
    if (s.chroma_format_idc) b.ue();
    for (int list = 0; list < (sl.slice_type == 1 ? 2 : 1); ++list) {
      int count = list == 0 ? sl.num_ref_idx_l0 : num_ref_idx_l1;
      for (int i = 0; i < count; ++i) {
        if (b.u(1)) {
          b.se();
          b.se();
        }
        if (s.chroma_format_idc && b.u(1))
          for (int j = 0; j < 2; ++j) {
            b.se();
            b.se();
          }
      }
    }
  }
  if (nal_ref_idc) {  // dec_ref_pic_marking
    if (idr) {
      b.u(1);  // no_output_of_prior_pics
      if (b.u(1)) {
        p.disable();  // long_term_reference_flag
        return false;
      }
    } else if (b.u(1)) {  // adaptive_ref_pic_marking_mode
      const int max_fn = 1 << s.log2_max_frame_num;
      while (true) {
        uint32_t op = b.ue();
        if (op == 0) break;
        if (op == 1) {
          int diff = (int)b.ue() + 1;
          int picnum = sl.frame_num - diff;
          int fn = picnum < 0 ? picnum + max_fn : picnum;
          for (auto it = p.short_term_frame_nums.begin();
               it != p.short_term_frame_nums.end(); ++it)
            if (*it == fn) {
              p.short_term_frame_nums.erase(it);
              break;
            }
        } else {
          p.disable();  // long-term ops
          return false;
        }
        if (b.err) {
          p.disable();
          return false;
        }
      }
    }
  }
  if (q.entropy_coding_mode && sl.slice_type != 2) b.ue();  // cabac_init_idc
  b.se();  // slice_qp_delta
  // SP/SI would add bits here; slice types 3/4 are rejected by the caller.
  if (q.deblocking_filter_control_present) {
    uint32_t dfc = b.ue();
    if (dfc != 1) {
      b.se();
      b.se();
    }
  }
  return !b.err;
}

// --- CAVLC residual block (9.2). Returns total_coeff or -1 on error. -------
static int residual_block(Bits& b, int nC, int max_coeff) {
  const Tables& T = tables();
  int total_coeff, trailing_ones;
  if (nC == -1) {  // chroma DC
    int sym = T.chroma_dc_coeff_token.get(b);
    if (sym < 0) return -1;
    total_coeff = sym >> 2;
    trailing_ones = sym & 3;
  } else {
    int tab = nC < 2 ? 0 : nC < 4 ? 1 : nC < 8 ? 2 : 3;
    int sym = T.coeff_token[tab].get(b);
    if (sym < 0) return -1;
    total_coeff = sym >> 2;
    trailing_ones = sym & 3;
  }
  if (total_coeff == 0) return 0;
  if (total_coeff > max_coeff) return -1;

  // trailing one signs
  b.u(trailing_ones);

  int suffix_len = (total_coeff > 10 && trailing_ones < 3) ? 1 : 0;
  for (int i = 0; i < total_coeff - trailing_ones; ++i) {
    // level_prefix: unary
    int prefix = 0;
    while (true) {
      size_t byte = b.pos >> 3;
      if (byte >= b.n) {
        b.err = true;
        return -1;
      }
      if ((b.d[byte] >> (7 - (b.pos & 7))) & 1) break;
      ++b.pos;
      if (++prefix > 47) {
        b.err = true;
        return -1;
      }
    }
    ++b.pos;
    int suffix_size = suffix_len;
    if (prefix == 14 && suffix_len == 0)
      suffix_size = 4;
    else if (prefix >= 15)
      suffix_size = prefix - 3;
    int level_suffix = suffix_size > 0 ? (int)b.u(suffix_size) : 0;
    int level_code =
        ((prefix < 15 ? prefix : 15) << suffix_len) + level_suffix;
    if (prefix >= 15 && suffix_len == 0) level_code += 15;
    if (prefix >= 16) level_code += (1 << (prefix - 3)) - 4096;
    if (i == 0 && trailing_ones < 3) level_code += 2;
    int level = (level_code % 2 == 0) ? (level_code + 2) >> 1
                                      : -((level_code + 1) >> 1);
    if (suffix_len == 0) suffix_len = 1;
    int abs_level = level < 0 ? -level : level;
    if (abs_level > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
  }

  int zeros_left = 0;
  if (total_coeff < max_coeff) {
    if (nC == -1) {
      int sym = T.chroma_dc_total_zeros[total_coeff - 1].get(b);
      if (sym < 0) return -1;
      zeros_left = sym;
    } else {
      int sym = T.total_zeros[total_coeff - 1].get(b);
      if (sym < 0) return -1;
      zeros_left = sym;
    }
  }
  for (int i = 0; i < total_coeff - 1 && zeros_left > 0; ++i) {
    int tab = (zeros_left < 7 ? zeros_left : 7) - 1;
    int run = T.run_before[tab].get(b);
    if (run < 0) return -1;
    zeros_left -= run;
    if (zeros_left < 0) return -1;
  }
  return b.err ? -1 : total_coeff;
}

// --- neighbour nC ------------------------------------------------------------
// 4x4 luma block index -> (x, y) offset in 4x4 units within the MB (z-scan).
static const int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
static const int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

struct MbCtx {
  Parser* p;
  const Slice* sl;
  int mb_w, mb_h;
  int mb_x, mb_y;

  bool nb_available(int nx_mb, int ny_mb) const {
    if (nx_mb < 0 || ny_mb < 0 || nx_mb >= mb_w || ny_mb >= mb_h) return false;
    return p->mb_slice[ny_mb * mb_w + nx_mb] == sl->slice_id;
  }
  // nC for luma 4x4 block blk (absolute 4x4 coords).
  int luma_nc(int blk) const {
    int bx = mb_x * 4 + kBlkX[blk], by = mb_y * 4 + kBlkY[blk];
    int stride = mb_w * 4;
    bool availA = bx > 0 && nb_available((bx - 1) / 4, by / 4);
    bool availB = by > 0 && nb_available(bx / 4, (by - 1) / 4);
    int nA = availA ? p->nz_luma[by * stride + bx - 1] : 0;
    int nB = availB ? p->nz_luma[(by - 1) * stride + bx] : 0;
    if (availA && availB) return (nA + nB + 1) >> 1;
    if (availA) return nA;
    if (availB) return nB;
    return 0;
  }
  void set_luma(int blk, int count) const {
    int bx = mb_x * 4 + kBlkX[blk], by = mb_y * 4 + kBlkY[blk];
    p->nz_luma[by * (mb_w * 4) + bx] = (uint8_t)count;
  }
  int chroma_nc(int comp, int blk) const {  // blk 0..3, 2x2 per MB
    int bx = mb_x * 2 + (blk & 1), by = mb_y * 2 + (blk >> 1);
    int stride = mb_w * 2;
    const auto& nz = p->nz_chroma[comp];
    bool availA = bx > 0 && nb_available((bx - 1) / 2, by / 2);
    bool availB = by > 0 && nb_available(bx / 2, (by - 1) / 2);
    int nA = availA ? nz[by * stride + bx - 1] : 0;
    int nB = availB ? nz[(by - 1) * stride + bx] : 0;
    if (availA && availB) return (nA + nB + 1) >> 1;
    if (availA) return nA;
    if (availB) return nB;
    return 0;
  }
  void set_chroma(int comp, int blk, int count) const {
    int bx = mb_x * 2 + (blk & 1), by = mb_y * 2 + (blk >> 1);
    p->nz_chroma[comp][by * (mb_w * 2) + bx] = (uint8_t)count;
  }
  void zero_all() const {
    for (int i = 0; i < 16; ++i) set_luma(i, 0);
    for (int c = 0; c < 2; ++c)
      for (int i = 0; i < 4; ++i) set_chroma(c, i, 0);
  }
  void set_all(int v) const {
    for (int i = 0; i < 16; ++i) set_luma(i, v);
    for (int c = 0; c < 2; ++c)
      for (int i = 0; i < 4; ++i) set_chroma(c, i, v);
  }
};

// residual() for one MB. cbp_luma 4 bits, cbp_chroma 0..2; i16 = Intra_16x16.
static bool parse_residual(Bits& b, const MbCtx& mb, int cbp_luma,
                           int cbp_chroma, bool i16) {
  if (i16) {
    // luma DC: 16 coeffs, nC from block 0's neighbours; does not update nz.
    if (residual_block(b, mb.luma_nc(0), 16) < 0) return false;
  }
  for (int i8 = 0; i8 < 4; ++i8) {
    if (cbp_luma & (1 << i8)) {
      for (int i4 = 0; i4 < 4; ++i4) {
        int blk = i8 * 4 + i4;
        int tc = residual_block(b, mb.luma_nc(blk), i16 ? 15 : 16);
        if (tc < 0) return false;
        mb.set_luma(blk, tc);
      }
    } else {
      for (int i4 = 0; i4 < 4; ++i4) mb.set_luma(i8 * 4 + i4, 0);
    }
  }
  if (cbp_chroma) {
    for (int c = 0; c < 2; ++c)
      if (residual_block(b, -1, 4) < 0) return false;
  }
  for (int c = 0; c < 2; ++c) {
    for (int blk = 0; blk < 4; ++blk) {
      if (cbp_chroma == 2) {
        int tc = residual_block(b, mb.chroma_nc(c, blk), 15);
        if (tc < 0) return false;
        mb.set_chroma(c, blk, tc);
      } else {
        mb.set_chroma(c, blk, 0);
      }
    }
  }
  return true;
}

// Parse one macroblock_layer in a P slice; writes ref (4 int8) for the MB.
// Returns false on parse error (stream desync).
static bool parse_p_macroblock(Parser& p, Bits& b, const Slice& sl,
                               MbCtx& mb, int8_t* ref) {
  const Pps& q = *sl.pps;
  uint32_t mb_type = b.ue();
  if (b.err) return false;

  if (mb_type >= 5) {
    // ---- intra MB in P slice --------------------------------------------
    uint32_t t = mb_type - 5;
    ref[0] = ref[1] = ref[2] = ref[3] = -1;
    if (t == 25) {  // I_PCM
      b.align();
      b.skip_bytes(256 + 128);  // 8-bit 4:2:0
      mb.set_all(16);
      return !b.err;
    }
    int cbp_luma, cbp_chroma;
    bool i16 = t >= 1;
    if (!i16) {  // I_NxN
      bool t8 = false;
      if (q.transform_8x8_mode) t8 = b.u(1);
      int n_pred = t8 ? 4 : 16;
      for (int i = 0; i < n_pred; ++i)
        if (!b.u(1)) b.u(3);  // rem_intra_pred_mode
      b.ue();                 // intra_chroma_pred_mode
      int code = b.ue();
      if (code > 47 || b.err) return false;
      int cbp = kGolombToIntra4x4Cbp[code];
      cbp_luma = cbp & 15;
      cbp_chroma = cbp >> 4;
    } else {  // I_16x16: CBP folded into mb_type
      b.ue();  // intra_chroma_pred_mode
      cbp_luma = ((t - 1) / 12) ? 15 : 0;
      cbp_chroma = ((t - 1) / 4) % 3;
    }
    if (cbp_luma || cbp_chroma || i16) b.se();  // mb_qp_delta
    return parse_residual(b, mb, cbp_luma, cbp_chroma, i16);
  }

  // ---- inter MB ----------------------------------------------------------
  const int nref = sl.num_ref_idx_l0;
  auto read_ref = [&]() -> int8_t {
    int idx = nref > 1 ? (int)b.te(nref - 1) : 0;
    if (idx >= (int)sl.hops.size()) idx = (int)sl.hops.size() - 1;
    return sl.hops[idx];
  };
  bool no_sub_lt8 = true;
  if (mb_type == 0) {  // P_L0_16x16
    int8_t r = read_ref();
    ref[0] = ref[1] = ref[2] = ref[3] = r;
    b.se();
    b.se();
  } else if (mb_type == 1) {  // P_L0_L0_16x8
    int8_t r0 = read_ref();
    int8_t r1 = read_ref();
    ref[0] = ref[1] = r0;
    ref[2] = ref[3] = r1;
    for (int i = 0; i < 2; ++i) {
      b.se();
      b.se();
    }
  } else if (mb_type == 2) {  // P_L0_L0_8x16
    int8_t r0 = read_ref();
    int8_t r1 = read_ref();
    ref[0] = ref[2] = r0;
    ref[1] = ref[3] = r1;
    for (int i = 0; i < 2; ++i) {
      b.se();
      b.se();
    }
  } else {  // P_8x8 (3) / P_8x8ref0 (4)
    int sub_type[4];
    static const int kSubParts[4] = {1, 2, 2, 4};  // 8x8, 8x4, 4x8, 4x4
    for (int i = 0; i < 4; ++i) {
      sub_type[i] = b.ue();
      if (sub_type[i] > 3 || b.err) return false;
      if (sub_type[i] != 0) no_sub_lt8 = false;
    }
    if (mb_type == 3) {
      for (int i = 0; i < 4; ++i) ref[i] = read_ref();
    } else {
      int8_t r0 = sl.hops.empty() ? 0 : sl.hops[0];
      ref[0] = ref[1] = ref[2] = ref[3] = r0;
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < kSubParts[sub_type[i]]; ++j) {
        b.se();
        b.se();
      }
  }
  if (b.err) return false;

  int code = b.ue();
  if (code > 47 || b.err) return false;
  int cbp = kGolombToInterCbp[code];
  int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
  if (cbp_luma && q.transform_8x8_mode && no_sub_lt8)
    b.u(1);  // transform_size_8x8_flag (no effect on CAVLC layout)
  if (cbp_luma || cbp_chroma) b.se();  // mb_qp_delta
  return parse_residual(b, mb, cbp_luma, cbp_chroma, false);
}

// Parse a P slice's data into map.ref. Returns false on desync (the caller
// drops the map; the decoder falls back to ref=0 for this frame).
static bool parse_p_slice_data(Parser& p, Bits& b, Slice& sl, RefMap& map) {
  const int mb_count = map.mb_w * map.mb_h;
  int addr = sl.first_mb;
  MbCtx mb{&p, &sl, map.mb_w, map.mb_h, 0, 0};

  bool more = true;
  while (more) {
    uint32_t skip_run = b.ue();
    if (b.err) return false;
    for (uint32_t s = 0; s < skip_run; ++s) {
      if (addr >= mb_count) return false;
      mb.mb_x = addr % map.mb_w;
      mb.mb_y = addr / map.mb_w;
      p.mb_slice[addr] = sl.slice_id;
      mb.zero_all();
      int8_t r = sl.hops.empty() ? 0 : sl.hops[0];  // P_Skip: ref_idx 0
      for (int i = 0; i < 4; ++i) map.ref[addr * 4 + i] = r;
      ++addr;
    }
    more = b.more_rbsp_data();
    if (!more) break;
    if (addr >= mb_count) return false;
    mb.mb_x = addr % map.mb_w;
    mb.mb_y = addr / map.mb_w;
    p.mb_slice[addr] = sl.slice_id;
    if (!parse_p_macroblock(p, b, sl, mb, &map.ref[addr * 4])) return false;
    ++addr;
    more = b.more_rbsp_data();
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
struct RefIdxParser {
  Parser p;
  int64_t last_pts = INT64_MIN;
};

extern "C" {

RefIdxParser* refidx_create() { return new RefIdxParser(); }
void refidx_destroy(RefIdxParser* h) { delete h; }
int refidx_ok(RefIdxParser* h) { return h && !h->p.disabled; }

// Configure from an ISO-BMFF avcC box (AVCodecParameters.extradata when the
// first byte is 1): records the NAL length size and parses the embedded
// SPS/PPS sets.
int refidx_set_avcc(RefIdxParser* h, const uint8_t* d, size_t n) {
  if (!h || n < 7 || d[0] != 1) return -1;
  Parser& p = h->p;
  p.nal_length_size = (d[4] & 3) + 1;
  size_t pos = 5;
  int n_sps = d[pos++] & 31;
  for (int i = 0; i < n_sps && pos + 2 <= n; ++i) {
    size_t len = ((size_t)d[pos] << 8) | d[pos + 1];
    pos += 2;
    if (pos + len > n) return -1;
    if (len > 1) {
      unescape(p, d + pos + 1, len - 1);
      Bits b;
      b.init(p.rbsp.data(), p.rbsp.size());
      parse_sps(p, b);
    }
    pos += len;
  }
  if (pos >= n) return -1;
  int n_pps = d[pos++];
  for (int i = 0; i < n_pps && pos + 2 <= n; ++i) {
    size_t len = ((size_t)d[pos] << 8) | d[pos + 1];
    pos += 2;
    if (pos + len > n) return -1;
    if (len > 1) {
      unescape(p, d + pos + 1, len - 1);
      Bits b;
      b.init(p.rbsp.data(), p.rbsp.size());
      parse_pps(p, b);
    }
    pos += len;
  }
  return 0;
}

// Parse one demuxed access unit. Returns 1 if a P-frame ref map was stored
// under `pts`, 0 otherwise (I/B frames, unsupported features, parse bail).
int refidx_feed(RefIdxParser* h, const uint8_t* data, size_t size,
                int64_t pts) {
  if (!h || h->p.disabled || !data || !size) return 0;
  Parser& p = h->p;

  // Split NALs: AVCC (length-prefixed) or Annex-B (start codes).
  std::vector<std::pair<const uint8_t*, size_t>> nals;
  if (p.nal_length_size) {
    size_t pos = 0;
    while (pos + p.nal_length_size <= size) {
      size_t len = 0;
      for (int i = 0; i < p.nal_length_size; ++i)
        len = (len << 8) | data[pos + i];
      pos += p.nal_length_size;
      if (len == 0 || pos + len > size) break;
      nals.emplace_back(data + pos, len);
      pos += len;
    }
  } else {
    size_t i = 0;
    ptrdiff_t start = -1;
    while (i + 2 < size) {
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
        if (start >= 0) {
          size_t end = i;
          while (end > (size_t)start && data[end - 1] == 0) --end;
          nals.emplace_back(data + start, end - start);
        }
        start = (ptrdiff_t)(i + 3);
        i += 3;
      } else {
        ++i;
      }
    }
    if (start >= 0 && (size_t)start < size)
      nals.emplace_back(data + start, size - start);
  }

  RefMap map;
  bool have_map = false, frame_is_ref = false, map_valid = true;
  int frame_num = -1;

  for (auto& [nd, nn] : nals) {
    if (nn < 1) continue;
    int nal_ref_idc = (nd[0] >> 5) & 3;
    int nal_type = nd[0] & 31;
    if (nal_type == 7 || nal_type == 8 || nal_type == 1 || nal_type == 5) {
      unescape(p, nd + 1, nn - 1);
      Bits b;
      b.init(p.rbsp.data(), p.rbsp.size());
      if (nal_type == 7) {
        parse_sps(p, b);
        continue;
      }
      if (nal_type == 8) {
        parse_pps(p, b);
        continue;
      }
      // slice
      bool idr = nal_type == 5;
      Slice sl{};
      sl.first_mb = b.ue();
      uint32_t st = b.ue();
      int pps_id = b.ue();
      if (b.err) return 0;
      if (st > 9) return 0;
      sl.slice_type = st % 5;
      if (sl.slice_type > 2) {  // SP/SI
        p.disable();
        return 0;
      }
      if (sl.slice_type == 1) {
        // B slices: frame_num counts reference frames only, so the hop
        // values recovered for the stream's P frames would be in ref-frame
        // units, not display frames — the same limitation the reference's
        // patched export has (VideoDecoder.cc treats ref as picture hops;
        // its operating point is bframes=0, README.md:47). Disable cleanly
        // and drop any maps not yet consumed.
        p.disable();
        p.maps.clear();
        return 0;
      }
      auto qit = p.pps_by_id.find(pps_id);
      if (qit == p.pps_by_id.end() || !qit->second.ok) return 0;
      sl.pps = &qit->second;
      auto sit = p.sps_by_id.find(sl.pps->sps_id);
      if (sit == p.sps_by_id.end() || !sit->second.ok) return 0;
      sl.sps = &sit->second;
      if (sl.pps->entropy_coding_mode) {
        p.disable();  // CABAC out of scope
        return 0;
      }
      if (idr) p.short_term_frame_nums.clear();

      sl.is_ref = nal_ref_idc != 0;
      sl.slice_id = ++p.slice_counter;
      if (!parse_slice_header(p, b, sl, idr, nal_ref_idc)) {
        if (p.disabled) return 0;
        map_valid = false;
        frame_num = sl.frame_num;
        frame_is_ref = frame_is_ref || sl.is_ref;
        continue;
      }
      frame_num = sl.frame_num;
      frame_is_ref = frame_is_ref || sl.is_ref;

      if (sl.slice_type == 0 && map_valid) {  // P slice: parse the data
        const Sps& s = *sl.sps;
        if (!have_map) {
          map.mb_w = s.mb_w;
          map.mb_h = s.mb_h;
          map.ref.assign((size_t)s.mb_w * s.mb_h * 4, -1);
          size_t l = (size_t)s.mb_w * 4 * s.mb_h * 4;
          size_t c = (size_t)s.mb_w * 2 * s.mb_h * 2;
          if (p.nz_luma.size() != l) p.nz_luma.assign(l, 0);
          if (p.nz_chroma[0].size() != c) {
            p.nz_chroma[0].assign(c, 0);
            p.nz_chroma[1].assign(c, 0);
          }
          if (p.mb_slice.size() != (size_t)s.mb_w * s.mb_h)
            p.mb_slice.assign((size_t)s.mb_w * s.mb_h, -1);
          std::fill(p.mb_slice.begin(), p.mb_slice.end(), -1);
          have_map = true;
        }
        if (!parse_p_slice_data(p, b, sl, map)) map_valid = false;
      }
    }
  }

  // Reference bookkeeping (sliding window) happens once per access unit.
  if (frame_num >= 0 && frame_is_ref) {
    if (p.short_term_frame_nums.empty() ||
        p.short_term_frame_nums.back() != frame_num)
      p.short_term_frame_nums.push_back(frame_num);
    int max_refs = 1;
    if (!p.sps_by_id.empty())
      max_refs = p.sps_by_id.begin()->second.max_num_ref_frames;
    while ((int)p.short_term_frame_nums.size() > max_refs && max_refs > 0)
      p.short_term_frame_nums.erase(p.short_term_frame_nums.begin());
  }

  if (have_map && map_valid) {
    p.maps[pts] = std::move(map);
    if (p.maps.size() > 64) p.maps.erase(p.maps.begin());
    return 1;
  }
  return 0;
}

const int8_t* refidx_get(RefIdxParser* h, int64_t pts, int* mb_w, int* mb_h) {
  if (!h) return nullptr;
  auto it = h->p.maps.find(pts);
  if (it == h->p.maps.end()) return nullptr;
  if (mb_w) *mb_w = it->second.mb_w;
  if (mb_h) *mb_h = it->second.mb_h;
  return it->second.ref.data();
}

void refidx_gc(RefIdxParser* h, int64_t min_pts) {
  if (!h) return;
  auto& m = h->p.maps;
  m.erase(m.begin(), m.lower_bound(min_pts));
}

}  // extern "C"
