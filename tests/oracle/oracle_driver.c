/*
 * oracle_driver.c — test harness exposing the REFERENCE codec's stage
 * functions as file-in/file-out subcommands.
 *
 * This file is OUR test infrastructure.  It is compiled against the reference
 * codec sources in-place under /root/reference (read-only, portable C) so the
 * test suite can verify bit-exactness of the JAX framework against the
 * genuine article.  No reference code is copied into this repository; this
 * driver only *calls* it (lossless_decode, idct, ycbcr_to_rgb, fdct,
 * quantize_I/P, lossless_encode — see tests/oracle/build_oracle.py for the
 * compile line).
 *
 * Subcommands (all integers little-endian, raw binary files):
 *   decode in.mpg out.raw
 *       Full container decode; out.raw = num_frames x (W*H*4) RGBA bytes.
 *       Replicates the loop of decoder/mjpeg423_decoder.c:90-134 without the
 *       BMP writer.
 *   lossless_dec in.bits nblocks is_p quant(y|c) state.i16 out.i16
 *       One plane entropy decode; state.i16 ("-" for zeroed) is the previous
 *       frame's dequantized coefficients (P accumulates into it).
 *   lossless_enc in.i16 nblocks out.bits
 *       Returns u32 byte length followed by the bitstream.
 *   idct in.i16 nblocks out.u8
 *   fdct in.u8 nblocks out.i16
 *   quant_i in.i16 nblocks quant(y|c) out.i16 next.i16
 *   quant_p in.i16 prev.i16 nblocks quant(y|c) out.i16 newprev.i16
 *   ycbcr2rgb y.u8 cb.u8 cr.u8 w h out.rgba   (whole frame, block order in)
 *   rgb2ycbcr in.rgba w h y.u8 cb.u8 cr.u8    (block order out)
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>

#include "mjpeg423_types.h"

/* Reference entry points (decoder/mjpeg423_decoder.h, encoder/mjpeg423_encoder.h) */
void lossless_decode(int num_blocks, void* bitstream, dct_block_t* DCACq,
                     dct_block_t quant, bool P);
void idct(pdct_block_t DCAC, pcolor_block_t block);
void ycbcr_to_rgb(int h, int w, uint32_t w_size, pcolor_block_t Y,
                  pcolor_block_t Cb, pcolor_block_t Cr, rgb_pixel_t* rgbblock);
void rgb_to_ycbcr(int h, int w, uint32_t w_size, rgb_pixel_t* rgbblock,
                  pcolor_block_t Y, pcolor_block_t Cb, pcolor_block_t Cr);
void fdct(pcolor_block_t block, pdct_block_t DCAC);
void quantize_I(DCTELEM* prev, pdct_block_t quant, pdct_block_t DCAC,
                pdct_block_t DCACq, pdct_block_t DCACq_next);
void quantize_P(pdct_block_t quant, pdct_block_t DCACq_prev, pdct_block_t DCAC,
                pdct_block_t DCACq);
uint32_t lossless_encode(int num_blocks, dct_block_t* DCACq, void* bitstream);

static void die(const char* msg) { fprintf(stderr, "oracle: %s\n", msg); exit(1); }

static void* xmalloc(size_t n) {
  void* p = malloc(n);
  if (!p) die("out of memory");
  return p;
}

static uint8_t* read_all(const char* path, size_t* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) die("cannot open input");
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t* buf = xmalloc((size_t)len + 64); /* slack for 32-bit lookahead */
  memset(buf + len, 0, 64);
  if (fread(buf, 1, (size_t)len, f) != (size_t)len) die("short read");
  fclose(f);
  *out_len = (size_t)len;
  return buf;
}

static void write_all(const char* path, const void* data, size_t len) {
  FILE* f = fopen(path, "wb");
  if (!f) die("cannot open output");
  if (fwrite(data, 1, len, f) != len) die("short write");
  fclose(f);
}

static pdct_block_t quant_by_name(const char* s) {
  if (s[0] == 'y') return Yquant;
  return Cquant;
}

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

static int cmd_decode(const char* in_path, const char* out_path) {
  size_t len;
  uint8_t* data = read_all(in_path, &len);
  uint32_t num_frames = rd_u32(data + 0);
  uint32_t w = rd_u32(data + 4);
  uint32_t h = rd_u32(data + 8);
  int nb = (int)((w / 8) * (h / 8));

  dct_block_t* ydcac = xmalloc((size_t)nb * sizeof(dct_block_t));
  dct_block_t* cbdcac = xmalloc((size_t)nb * sizeof(dct_block_t));
  dct_block_t* crdcac = xmalloc((size_t)nb * sizeof(dct_block_t));
  color_block_t* yb = xmalloc((size_t)nb * sizeof(color_block_t));
  color_block_t* cbb = xmalloc((size_t)nb * sizeof(color_block_t));
  color_block_t* crb = xmalloc((size_t)nb * sizeof(color_block_t));
  rgb_pixel_t* rgb = xmalloc((size_t)w * h * sizeof(rgb_pixel_t));

  FILE* out = fopen(out_path, "wb");
  if (!out) die("cannot open output");

  size_t off = 20;
  for (uint32_t fi = 0; fi < num_frames; fi++) {
    uint32_t frame_size = rd_u32(data + off);
    uint32_t frame_type = rd_u32(data + off + 4);
    uint32_t ysize = rd_u32(data + off + 8);
    uint32_t cbsize = rd_u32(data + off + 12);
    uint8_t* ybits = data + off + 16;
    uint8_t* cbbits = ybits + ysize;
    uint8_t* crbits = cbbits + cbsize;

    lossless_decode(nb, ybits, ydcac, Yquant, (int)frame_type);
    lossless_decode(nb, cbbits, cbdcac, Cquant, (int)frame_type);
    lossless_decode(nb, crbits, crdcac, Cquant, (int)frame_type);
    for (int b = 0; b < nb; b++) idct(ydcac[b], yb[b]);
    for (int b = 0; b < nb; b++) idct(cbdcac[b], cbb[b]);
    for (int b = 0; b < nb; b++) idct(crdcac[b], crb[b]);
    for (uint32_t bh = 0; bh < h / 8; bh++)
      for (uint32_t bw = 0; bw < w / 8; bw++) {
        int b = (int)(bh * (w / 8) + bw);
        ycbcr_to_rgb((int)(bh << 3), (int)(bw << 3), w, yb[b], cbb[b], crb[b], rgb);
      }
    if (fwrite(rgb, sizeof(rgb_pixel_t), (size_t)w * h, out) != (size_t)w * h)
      die("short write");
    off += frame_size;
  }
  fclose(out);
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 2) die("usage: oracle_driver <cmd> ...");
  const char* cmd = argv[1];
  size_t len;

  if (!strcmp(cmd, "decode")) {
    return cmd_decode(argv[2], argv[3]);

  } else if (!strcmp(cmd, "lossless_dec")) {
    int nb = atoi(argv[3]);
    int is_p = atoi(argv[4]);
    pdct_block_t quant = quant_by_name(argv[5]);
    uint8_t* bits = read_all(argv[2], &len);
    dct_block_t* state = xmalloc((size_t)nb * sizeof(dct_block_t));
    if (strcmp(argv[6], "-")) {
      size_t slen;
      uint8_t* sdata = read_all(argv[6], &slen);
      if (slen != (size_t)nb * sizeof(dct_block_t)) die("bad state size");
      memcpy(state, sdata, slen);
    } else {
      memset(state, 0, (size_t)nb * sizeof(dct_block_t));
    }
    lossless_decode(nb, bits, state, quant, is_p);
    write_all(argv[7], state, (size_t)nb * sizeof(dct_block_t));
    return 0;

  } else if (!strcmp(cmd, "lossless_enc")) {
    int nb = atoi(argv[3]);
    uint8_t* coefs = read_all(argv[2], &len);
    if (len != (size_t)nb * sizeof(dct_block_t)) die("bad coef size");
    /* worst case ~2 bytes/coeff plus slack */
    uint8_t* bits = xmalloc((size_t)nb * 64 * 3 + 64);
    uint32_t n = lossless_encode(nb, (dct_block_t*)coefs, bits);
    FILE* f = fopen(argv[4], "wb");
    if (!f) die("cannot open output");
    fwrite(&n, 4, 1, f);
    fwrite(bits, 1, n, f);
    fclose(f);
    return 0;

  } else if (!strcmp(cmd, "idct")) {
    int nb = atoi(argv[3]);
    uint8_t* coefs = read_all(argv[2], &len);
    color_block_t* out = xmalloc((size_t)nb * sizeof(color_block_t));
    for (int b = 0; b < nb; b++) idct(((dct_block_t*)coefs)[b], out[b]);
    write_all(argv[4], out, (size_t)nb * sizeof(color_block_t));
    return 0;

  } else if (!strcmp(cmd, "fdct")) {
    int nb = atoi(argv[3]);
    uint8_t* samples = read_all(argv[2], &len);
    dct_block_t* out = xmalloc((size_t)nb * sizeof(dct_block_t));
    for (int b = 0; b < nb; b++) fdct(((color_block_t*)samples)[b], out[b]);
    write_all(argv[4], out, (size_t)nb * sizeof(dct_block_t));
    return 0;

  } else if (!strcmp(cmd, "quant_i")) {
    int nb = atoi(argv[3]);
    pdct_block_t quant = quant_by_name(argv[4]);
    uint8_t* coefs = read_all(argv[2], &len);
    dct_block_t* out = xmalloc((size_t)nb * sizeof(dct_block_t));
    dct_block_t* next = xmalloc((size_t)nb * sizeof(dct_block_t));
    DCTELEM prev = 0;
    for (int b = 0; b < nb; b++)
      quantize_I(&prev, quant, ((dct_block_t*)coefs)[b], out[b], next[b]);
    write_all(argv[5], out, (size_t)nb * sizeof(dct_block_t));
    write_all(argv[6], next, (size_t)nb * sizeof(dct_block_t));
    return 0;

  } else if (!strcmp(cmd, "quant_p")) {
    int nb = atoi(argv[4]);
    pdct_block_t quant = quant_by_name(argv[5]);
    uint8_t* coefs = read_all(argv[2], &len);
    uint8_t* prev = read_all(argv[3], &len);
    dct_block_t* out = xmalloc((size_t)nb * sizeof(dct_block_t));
    for (int b = 0; b < nb; b++)
      quantize_P(quant, ((dct_block_t*)prev)[b], ((dct_block_t*)coefs)[b], out[b]);
    write_all(argv[6], out, (size_t)nb * sizeof(dct_block_t));
    write_all(argv[7], prev, (size_t)nb * sizeof(dct_block_t));
    return 0;

  } else if (!strcmp(cmd, "ycbcr2rgb")) {
    uint32_t w = (uint32_t)atoi(argv[5]);
    uint32_t h = (uint32_t)atoi(argv[6]);
    uint8_t* y = read_all(argv[2], &len);
    uint8_t* cb = read_all(argv[3], &len);
    uint8_t* cr = read_all(argv[4], &len);
    rgb_pixel_t* rgb = xmalloc((size_t)w * h * sizeof(rgb_pixel_t));
    for (uint32_t bh = 0; bh < h / 8; bh++)
      for (uint32_t bw = 0; bw < w / 8; bw++) {
        int b = (int)(bh * (w / 8) + bw);
        ycbcr_to_rgb((int)(bh << 3), (int)(bw << 3), w,
                     ((color_block_t*)y)[b], ((color_block_t*)cb)[b],
                     ((color_block_t*)cr)[b], rgb);
      }
    write_all(argv[7], rgb, (size_t)w * h * sizeof(rgb_pixel_t));
    return 0;

  } else if (!strcmp(cmd, "rgb2ycbcr")) {
    uint32_t w = (uint32_t)atoi(argv[3]);
    uint32_t h = (uint32_t)atoi(argv[4]);
    uint8_t* rgba = read_all(argv[2], &len);
    int nb = (int)((w / 8) * (h / 8));
    color_block_t* y = xmalloc((size_t)nb * sizeof(color_block_t));
    color_block_t* cb = xmalloc((size_t)nb * sizeof(color_block_t));
    color_block_t* cr = xmalloc((size_t)nb * sizeof(color_block_t));
    for (int b = 0; b < nb; b++)
      rgb_to_ycbcr(b / (int)(w / 8) * 8, b % (int)(w / 8) * 8, w,
                   (rgb_pixel_t*)rgba, y[b], cb[b], cr[b]);
    write_all(argv[5], y, (size_t)nb * sizeof(color_block_t));
    write_all(argv[6], cb, (size_t)nb * sizeof(color_block_t));
    write_all(argv[7], cr, (size_t)nb * sizeof(color_block_t));
    return 0;
  }
  die("unknown command");
  return 1;
}
