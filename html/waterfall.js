/* Canvas spectrum waterfall for webradio.
 *
 * Behavioural parity with the reference widget (html/waterfall.js there):
 * one new spectrum row is painted at the top per update, the image scrolls
 * down one pixel per scroll tick, a frequency scale with centre marker is
 * drawn from centre frequency + sample rate, and dB values map onto a
 * cold-to-hot palette. Implementation is original: ImageData row blits and
 * a typed-array palette instead of per-pixel fillRect.
 */
"use strict";

class Waterfall {
  constructor(canvas, scaleCanvas) {
    this.canvas = canvas;
    this.ctx = canvas.getContext("2d", { willReadFrequently: true });
    this.scaleCanvas = scaleCanvas;
    this.centreFrequency = 0;
    this.sampleRate = 0;
    this.dbFloor = -50; // dB mapped to palette 0
    this.dbRange = 40;  // dB span of the palette
    this.palette = Waterfall.makePalette();
    this.row = this.ctx.createImageData(canvas.width, 1);
  }

  /* 256-entry palette: black -> blue -> green -> yellow -> red -> white */
  static makePalette() {
    const stops = [
      [0, 0, 0], [0, 0, 160], [0, 190, 160], [60, 200, 60],
      [230, 220, 50], [250, 80, 30], [255, 255, 255],
    ];
    const pal = new Uint8ClampedArray(256 * 3);
    for (let i = 0; i < 256; i++) {
      const x = (i / 255) * (stops.length - 1);
      const j = Math.min(Math.floor(x), stops.length - 2);
      const f = x - j;
      for (let k = 0; k < 3; k++) {
        pal[i * 3 + k] = stops[j][k] * (1 - f) + stops[j + 1][k] * f;
      }
    }
    return pal;
  }

  setTuning(centreFrequency, sampleRate) {
    if (centreFrequency !== this.centreFrequency ||
        sampleRate !== this.sampleRate) {
      this.centreFrequency = centreFrequency;
      this.sampleRate = sampleRate;
      this.drawScale();
    }
  }

  /* paint one spectrum (array of dB, ascending frequency) at row 0 */
  update(db) {
    const w = this.canvas.width;
    const n = db.length;
    const data = this.row.data;
    for (let x = 0; x < w; x++) {
      const v = db[Math.floor((x * n) / w)];
      let idx = Math.round(((v - this.dbFloor) / this.dbRange) * 255);
      idx = Math.max(0, Math.min(255, idx));
      data[x * 4] = this.palette[idx * 3];
      data[x * 4 + 1] = this.palette[idx * 3 + 1];
      data[x * 4 + 2] = this.palette[idx * 3 + 2];
      data[x * 4 + 3] = 255;
    }
    this.ctx.putImageData(this.row, 0, 0);
  }

  /* shift the whole image down one pixel (reference scrolls at 20 Hz) */
  scroll() {
    const { width, height } = this.canvas;
    this.ctx.drawImage(this.canvas, 0, 0, width, height - 1,
                       0, 1, width, height - 1);
  }

  drawScale() {
    if (!this.scaleCanvas) return;
    const ctx = this.scaleCanvas.getContext("2d");
    const w = this.scaleCanvas.width;
    const h = this.scaleCanvas.height;
    ctx.clearRect(0, 0, w, h);
    ctx.fillStyle = "#0f1419";
    ctx.fillRect(0, 0, w, h);
    if (!this.sampleRate) return;
    ctx.strokeStyle = "#8fa3b0";
    ctx.fillStyle = "#c8d6e0";
    ctx.font = "10px monospace";
    ctx.textAlign = "center";
    const f0 = this.centreFrequency - this.sampleRate / 2;
    const span = this.sampleRate;
    /* ticks every span/8 */
    for (let i = 0; i <= 8; i++) {
      const x = (i / 8) * w;
      const f = f0 + (i / 8) * span;
      ctx.beginPath();
      ctx.moveTo(x, 0);
      ctx.lineTo(x, 6);
      ctx.stroke();
      if (i > 0 && i < 8) {
        ctx.fillText((f / 1e6).toFixed(3), x, 16);
      }
    }
    /* centre marker */
    ctx.strokeStyle = "#ff5050";
    ctx.beginPath();
    ctx.moveTo(w / 2, 0);
    ctx.lineTo(w / 2, h);
    ctx.stroke();
  }
}

window.Waterfall = Waterfall;
