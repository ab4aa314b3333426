// Native host-side kernels for monortm-tpu (ctypes ABI).
//
// Two hot host paths get C++ implementations (the TPU compute path is
// JAX/XLA/Pallas; these are the *runtime* pieces around it):
//
//  1. group_resolve_lines: TAPE3 record stream -> resolved flat line
//     records, replicating GET_LNFL's per-molecule regrouping
//     (lnfl_mod.f90:43-117) and the LINES J/JJ coupling walk
//     (modm.f90:316-435).  250k-line catalogs resolve in milliseconds
//     instead of seconds of Python.
//
//  2. alayer_integrate: the refracted-ray sub-step integration for one
//     level interval (ALAYER, lblatm.f90:5289-5578) including
//     Curtis-Godson pressure/temperature/density sums and per-molecule
//     amounts.  Dominant cost of layering 10k-profile radiosonde runs.
//
// Build: make -C monortm_tpu/native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------
// 1. line grouping + coupling resolution
// ---------------------------------------------------------------------

struct RawLinesC {
  const double* vnu;
  const float* sp;
  const float* alfa;
  const float* epp;
  const int32_t* mol;
  const float* hwhm;
  const float* tmpalf;
  const float* pshift;
  const int32_t* iflg;
  const float* speed_dep;
  int64_t n;
};

struct ResolvedC {
  // capacity-n outputs; returns count written
  int64_t* mol;
  double* nu0;
  double* s0;
  double* e;
  double* alpf;
  double* alps;
  double* tdep;
  double* pshift;
  int64_t* iso;
  double* sdep;
  double* xg;
  double* a1;      // [n, 4]
  double* b1;
  double* a2;
  double* b2;
  uint8_t* self_mix;
};

int64_t group_resolve_lines(const RawLinesC* raw, ResolvedC* out) {
  const int64_t n = raw->n;
  // ---- group (GET_LNFL) ----
  // per-molecule entry lists
  static const int NMOL = 39;
  // first pass: count per molecule
  int64_t* mo_of = new int64_t[n];
  int64_t counts[NMOL + 1];
  std::memset(counts, 0, sizeof(counts));
  int64_t mo_prev = 0;
  for (int64_t k = 0; k < n; ++k) {
    const int32_t ifl = raw->iflg[k];
    int64_t mo;
    if (ifl >= 0 && ifl <= 100) {
      mo = ((int64_t)raw->mol[k]) % 100;
    } else if (ifl >= -3 && ifl <= -1) {
      mo = k > 0 ? ((int64_t)raw->mol[k - 1]) % 100 : 0;
    } else if (ifl == -5) {
      if (k > 0 && raw->iflg[k - 1] >= 0) {
        mo = ((int64_t)raw->mol[k - 1]) % 100;
        mo_prev = mo;
      } else {
        mo = mo_prev;
      }
    } else {
      delete[] mo_of;
      return -1;  // unrecognised flag
    }
    mo_of[k] = (mo >= 1 && mo <= NMOL) ? mo : 0;
    if (mo_of[k]) counts[mo]++;
  }
  // per-molecule index lists (storage order)
  int64_t offs[NMOL + 2];
  offs[1] = 0;
  for (int m = 1; m <= NMOL; ++m) offs[m + 1] = offs[m] + counts[m];
  int64_t total = offs[NMOL + 1];
  int64_t* order = new int64_t[total];
  int64_t fill[NMOL + 1];
  std::memcpy(fill, offs, sizeof(int64_t) * (NMOL + 1));
  for (int64_t k = 0; k < n; ++k) {
    if (mo_of[k]) order[fill[mo_of[k]]++] = k;
  }

  // grouped columns with molecule-specific corrections
  double* g_nu = new double[total];
  double* g_s0 = new double[total];
  double* g_alpf = new double[total];
  double* g_alps = new double[total];
  double* g_e = new double[total];
  double* g_x = new double[total];
  double* g_dn = new double[total];
  double* g_xg = new double[total];
  int64_t* g_iso = new int64_t[total];
  double* g_rmol = new double[total];
  double* g_sdep = new double[total];
  for (int64_t j = 0; j < total; ++j) {
    const int64_t k = order[j];
    const int64_t mo = mo_of[k];
    const bool normal = raw->iflg[k] >= 0;
    double alpf = raw->alfa[k];
    double alps = raw->hwhm[k];
    double dn = raw->pshift[k];
    if (mo == 7 && normal) {          // O2 air->foreign width
      const double rvmr = 0.21;
      alpf = (alpf - rvmr * alps) / (1.0 - rvmr);
    }
    if (mo == 22 && normal) {         // N2
      const double rvmr = 0.79;
      alpf = (alpf - rvmr * alps) / (1.0 - rvmr);
    }
    if (mo == 1 && alps == 0.0) alps = 5.0 * alpf;  // H2O (modm.f90:841)
    g_nu[j] = raw->vnu[k];
    g_s0[j] = raw->sp[k];
    g_alpf[j] = alpf;
    g_alps[j] = alps;
    g_e[j] = raw->epp[k];
    g_x[j] = raw->tmpalf[k];
    g_dn[j] = dn;
    g_xg[j] = normal ? -(double)raw->iflg[k] : (double)raw->iflg[k];
    int64_t am = raw->mol[k];
    if (am < 0) am = -am;
    g_iso[j] = (am % 1000) / 100;
    float fm;
    std::memcpy(&fm, &raw->mol[k], 4);   // RMOL bitcast
    g_rmol[j] = fm;
    g_sdep[j] = raw->speed_dep[k];
  }

  // ---- resolve (LINES J/JJ walk) ----
  int64_t w = 0;
  for (int m = 1; m <= NMOL; ++m) {
    const int64_t lo = offs[m], nb = counts[m];
    int64_t j = 0;
    while (j < nb) {
      int64_t jj = j;
      double a1[4] = {0, 0, 0, 0}, b1[4] = {0, 0, 0, 0};
      double a2[4] = {0, 0, 0, 0}, b2[4] = {0, 0, 0, 0};
      uint8_t smix = 0;
      const double xg = g_xg[lo + j];
      if (xg == -1.0 || xg == -3.0 || xg == -5.0) {
        jj = j + 1;
        if (jj < nb) {
          a1[0] = g_nu[lo + jj]; a1[1] = g_alpf[lo + jj];
          a1[2] = g_rmol[lo + jj]; a1[3] = g_x[lo + jj];
          b1[0] = g_s0[lo + jj]; b1[1] = g_e[lo + jj];
          b1[2] = g_alps[lo + jj]; b1[3] = g_dn[lo + jj];
        }
        if (xg == -5.0 && j >= 1 && g_xg[lo + j - 1] == -5.0) {
          jj += 1;
          if (jj < nb) {
            a2[0] = g_nu[lo + jj]; a2[1] = g_alpf[lo + jj];
            a2[2] = g_rmol[lo + jj]; a2[3] = g_x[lo + jj];
            b2[0] = g_s0[lo + jj]; b2[1] = g_e[lo + jj];
            b2[2] = g_alps[lo + jj]; b2[3] = g_dn[lo + jj];
            smix = 1;
          }
        }
      }
      out->mol[w] = m;
      out->nu0[w] = g_nu[lo + j];
      out->s0[w] = g_s0[lo + j];
      out->e[w] = g_e[lo + j];
      out->alpf[w] = g_alpf[lo + j];
      out->alps[w] = g_alps[lo + j];
      out->tdep[w] = g_x[lo + j];
      out->pshift[w] = g_dn[lo + j];
      out->iso[w] = g_iso[lo + j];
      out->sdep[w] = g_sdep[lo + j];
      out->xg[w] = g_xg[lo + j];
      for (int q = 0; q < 4; ++q) {
        out->a1[4 * w + q] = a1[q];
        out->b1[4 * w + q] = b1[q];
        out->a2[4 * w + q] = a2[q];
        out->b2[4 * w + q] = b2[q];
      }
      out->self_mix[w] = smix;
      ++w;
      j = jj + 1;
    }
  }

  delete[] mo_of;
  delete[] order;
  delete[] g_nu; delete[] g_s0; delete[] g_alpf; delete[] g_alps;
  delete[] g_e; delete[] g_x; delete[] g_dn; delete[] g_xg;
  delete[] g_iso; delete[] g_rmol; delete[] g_sdep;
  return w;
}

// ---------------------------------------------------------------------
// 2. refracted ray sub-step integration (ALAYER)
// ---------------------------------------------------------------------

static inline double andex(double h, double sh, double gamma) {
  return sh == 0.0 ? 1.0 + gamma : 1.0 + gamma * std::exp(-h / sh);
}
static inline double radref(double h, double sh, double gamma) {
  return sh == 0.0 ? 1.0e36 : sh * (1.0 + std::exp(h / sh) / gamma);
}

// One level interval j.  In/out state sinai/cosai; accumulates
// ppsum/tpsum/rhopsm (scalars for interval j) and amtp[nmol].
// Returns s; *bend_out gets the bending.
double alayer_integrate(
    double z1, double z2, double pa0, double pb0, double ta, double tb,
    const double* dena0, const double* denb0, int64_t nmol,
    double* sinai_io, double* cosai_io, double cpath, double sh,
    double gamma, double re, double deltas, double gcair, int iamt,
    double* ppsum, double* tpsum, double* rhopsm, double* amtp,
    double* bend_out) {
  const double epsiln = 1.0e-5;
  double sinai1 = *sinai_io, cosai1 = *cosai_io;
  double h1 = z1, r1 = re + h1;
  const double dhmin = deltas * deltas / (2.0 * r1);
  double y1 = 0.0, y3 = 0.0;
  if ((1.0 - sinai1) < epsiln)
    y1 = cosai1 * cosai1 / 2.0 + std::pow(cosai1, 4) / 8.0 +
         std::pow(cosai1, 6) * 3.0 / 48.0;
  double x1 = -r1 * cosai1;
  double ratio1 = r1 / radref(h1, sh, gamma);
  const double ratio_bottom = ratio1;
  const double ratio_top = (re + z2) / radref(z2, sh, gamma);
  double dsdx1 = 1.0 / (1.0 - ratio1 * sinai1 * sinai1);
  double dbndx1 = dsdx1 * sinai1 * ratio1 / r1;
  double s = 0.0, bend = 0.0;

  // amount-interpolation state
  double pa = pa0, rhoa = 0.0, hp = 0.0, hrho = 0.0;
  double dena[64], hden[64];
  const double dz = z2 - z1;
  if (iamt != 2) {
    const double rhob_lvl = pb0 / (gcair * tb);
    rhoa = pa0 / (gcair * ta);
    hp = -dz / std::log(pb0 / pa0);
    hrho = (std::fabs(rhob_lvl / rhoa - 1.0) >= epsiln)
               ? -dz / std::log(rhob_lvl / rhoa)
               : 1.0e30;
    for (int64_t k = 0; k < nmol; ++k) {
      dena[k] = dena0[k];
      const double da = dena0[k], db = denb0[k];
      hden[k] = (da == 0.0 || db == 0.0 || std::fabs(1.0 - da / db) <= epsiln)
                    ? 0.0
                    : -dz / std::log(db / da);
    }
  }

  double sinai3 = sinai1, cosai3 = cosai1, cosai2 = cosai1;
  for (;;) {
    double dh = -deltas * cosai1;
    if (dh < dhmin) dh = dhmin;
    double h3 = h1 + dh;
    if (h3 > z2) h3 = z2;
    dh = h3 - h1;
    const double r3 = re + h3;
    const double h2 = h1 + dh / 2.0;
    const double r2 = re + h2;
    const double sinai2 = cpath / (andex(h2, sh, gamma) * r2);
    sinai3 = cpath / (andex(h3, sh, gamma) * r3);
    const double ratio2 = r2 / radref(h2, sh, gamma);
    const double ratio3 = r3 / radref(h3, sh, gamma);
    double w1, w2, w3, x3;
    if ((1.0 - sinai2) <= epsiln) {
      y3 = y1 + (sinai1 * (1.0 - ratio1) / r1 +
                 4.0 * sinai2 * (1.0 - ratio2) / r2 +
                 sinai3 * (1.0 - ratio3) / r3) * dh / 6.0;
      double t = 2.0 * y3 - y3 * y3;
      cosai3 = -std::sqrt(t > 0.0 ? t : 0.0);
      x3 = -r3 * cosai3;
      const double dx = x3 - x1;
      w1 = 0.5 * dx; w2 = 0.0; w3 = 0.5 * dx;
    } else {
      cosai2 = -std::sqrt(1.0 - sinai2 * sinai2);
      cosai3 = -std::sqrt(1.0 - sinai3 * sinai3);
      const double x2 = -r2 * cosai2;
      x3 = -r3 * cosai3;
      const double d31 = x3 - x1, d32 = x3 - x2, d21 = x2 - x1;
      if (d32 == 0.0 || d21 == 0.0) {
        w1 = 0.5 * d31; w2 = 0.0; w3 = 0.5 * d31;
      } else {
        w1 = (2.0 - d32 / d21) * d31 / 6.0;
        w2 = d31 * d31 * d31 / (d32 * d21 * 6.0);
        w3 = (2.0 - d21 / d32) * d31 / 6.0;
      }
    }
    const double dsdx2 = 1.0 / (1.0 - ratio2 * sinai2 * sinai2);
    const double dsdx3 = 1.0 / (1.0 - ratio3 * sinai3 * sinai3);
    const double dbndx2 = dsdx2 * sinai2 * ratio2 / r2;
    const double dbndx3 = dsdx3 * sinai3 * ratio3 / r3;
    double ds = w1 * dsdx1 + w2 * dsdx2 + w3 * dsdx3;
    const double dbend = w1 * dbndx1 + w2 * dbndx2 + w3 * dbndx3;

    // MJA elevation fix: Fortran precedence A .or. (B .and. C); the
    // bending result is a dead store in the reference — only DS changes
    if (ratio_top >= 1.0 ||
        (ratio_bottom >= 1.0 && (1.0 - sinai2) > epsiln)) {
      const double d31 = r3 - r1, d32 = r3 - r2, d21 = r2 - r1;
      double v1, v2, v3;
      if (d32 == 0.0 || d21 == 0.0) {
        v1 = 0.5 * d31; v2 = 0.0; v3 = 0.5 * d31;
      } else {
        v1 = (2.0 - d32 / d21) * d31 / 6.0;
        v2 = d31 * d31 * d31 / (d32 * d21 * 6.0);
        v3 = (2.0 - d21 / d32) * d31 / 6.0;
      }
      ds = v1 * (-1.0 / cosai1) + v2 * (-1.0 / cosai2) +
           v3 * (-1.0 / cosai3);
    }

    s += ds;
    bend += dbend;

    if (iamt != 2) {
      const double dsdz = dh != 0.0 ? ds / dh : 0.0;
      const double pb = pa * std::exp(-dh / hp);
      const double rhob = rhoa * std::exp(-dh / hrho);
      if ((dh / hrho) >= epsiln) {
        *ppsum += dsdz * (hp / (1.0 + hp / hrho)) * (pa * rhoa - pb * rhob);
        *tpsum += dsdz * hp * (pa - pb) / gcair;
        *rhopsm += dsdz * hrho * (rhoa - rhob);
      } else {
        *ppsum += 0.5 * ds * (pa * rhoa + pb * rhob);
        *tpsum += 0.5 * ds * (pa + pb) / gcair;
        *rhopsm += 0.5 * ds * (rhoa + rhob);
      }
      for (int64_t k = 0; k < nmol; ++k) {
        double denb;
        if (hden[k] == 0.0 || std::fabs(dh / hden[k]) < epsiln) {
          denb = dena0[k] + (denb0[k] - dena0[k]) * (h3 - z1) / dz;
          amtp[k] += 0.5 * (dena[k] + denb) * ds * 1.0e5;
        } else {
          denb = dena0[k] * std::exp(-(h3 - z1) / hden[k]);
          amtp[k] += dsdz * hden[k] * (dena[k] - denb) * 1.0e5;
        }
        dena[k] = denb;
      }
      pa = pb;
      rhoa = rhob;
    }

    if (h3 < z2) {
      h1 = h3;
      r1 = r3;
      sinai1 = sinai3;
      ratio1 = ratio3;
      y1 = y3;
      cosai1 = cosai3;
      x1 = x3;
      dsdx1 = dsdx3;
      dbndx1 = dbndx3;
    } else {
      *sinai_io = sinai3;
      *cosai_io = cosai3;
      *bend_out = bend;
      return s;
    }
  }
}

// ---------------------------------------------------------------------
// 3. rfpath_integrate: the full RFPATH segment loop (lblatm.f90:5030-5105)
//    — SCALHT per interval, ALAYER integration, bending/zenith-angle
//    bookkeeping, and the LEN=1 tangent doubling.  One call per path
//    replaces O(levels) ctypes round trips.
//
//    zpth/pp/tp/rfndx: [ipmax]; denp: [ipmax, nmol] row-major.
//    Outputs: ppsum/tpsum/rhopsm/sp [ipmax-1] (zero-initialised by the
//    caller), amtp [ipmax-1, nmol] row-major, out[6] =
//    {s, beta, bendng, phi_j, sinai, cosai}.
// ---------------------------------------------------------------------

void rfpath_integrate(
    const double* zpth, const double* pp, const double* tp,
    const double* rfndx, const double* denp, int64_t nmol, int64_t ipmax,
    double sinai, double cosai, double cpath, double re, double deltas,
    double gcair, int iamt, double theta, int len1, int64_t iphmid,
    double* ppsum, double* tpsum, double* rhopsm, double* amtp, double* sp,
    double* out) {
  const double DEG = 180.0 / M_PI;
  double s = 0.0, beta = 0.0, bendng = 0.0, phi_j = 0.0;
  for (int64_t j = 0; j + 1 < ipmax; ++j) {
    // SCALHT (lblatm.f90:4856)
    const double rf1 = rfndx[j] + 1.0e-20;
    const double rf2 = rfndx[j + 1] + 1.0e-20;
    const double ratio = rf1 / rf2;
    double sh, gamma;
    if (std::fabs(ratio - 1.0) < 1.0e-5) {
      sh = 0.0;
      gamma = rfndx[j];
    } else {
      sh = (zpth[j + 1] - zpth[j]) / std::log(ratio);
      gamma = rf1 * std::pow(rf2 / rf1,
                             -zpth[j] / (zpth[j + 1] - zpth[j]));
    }
    double bend = 0.0;
    const double ds = alayer_integrate(
        zpth[j], zpth[j + 1], pp[j], pp[j + 1], tp[j], tp[j + 1],
        denp + j * nmol, denp + (j + 1) * nmol, nmol, &sinai, &cosai,
        cpath, sh, gamma, re, deltas, gcair, iamt, &ppsum[j], &tpsum[j],
        &rhopsm[j], amtp + j * nmol, &bend);
    sp[j] = ds;
    bend *= DEG;
    double sc = sinai < -1.0 ? -1.0 : (sinai > 1.0 ? 1.0 : sinai);
    phi_j = std::asin(sc) * DEG;
    const double dbeta = theta - phi_j + bend;
    phi_j = 180.0 - phi_j;
    s += ds;
    bendng += bend;
    beta += dbeta;
    theta = 180.0 - phi_j;
    if (len1 == 1 && (j + 2) == iphmid) {
      bendng *= 2.0;
      beta *= 2.0;
      s *= 2.0;
    }
  }
  out[0] = s;
  out[1] = beta;
  out[2] = bendng;
  out[3] = phi_j;
  out[4] = sinai;
  out[5] = cosai;
}

// ---------------------------------------------------------------------
// 4. amerge_walk: the AMERGE zout/zmdl merge walk (lblatm.f90:5190-5285)
//    — a scalar recurrence (tolerance snaps cascade into subsequent
//    comparisons) that merges path boundaries into the model-level grid
//    with exponential P / linear T interpolation at inserted points.
//    Dominant remaining Python cost of layering large stacked-sonde
//    runs; one call per path replaces an O(levels) interpreter loop.
//
//    zmdl/pm/tm/rfndx: [immax] model profile (zmdl is copied; the snap
//    mutates it).  zout: [ioutmx] merged boundary grid, ascending.
//    Outputs (caller-allocated capacity >= immax + ioutmx + 2):
//      zpth/pp/tp/rf  — path point values
//      src_im         — model-level index, or -1 for interpolated points
//      src_jm, src_a  — interpolation (jm, a) where src_im == -1
//      scal[0]=iphmid (1-based), scal[1] stores hmid on input/output.
//    Returns the number of path points, or -1 if the profile does not
//    extend up to hmin.
// ---------------------------------------------------------------------

static inline double expint_c(double x1, double x2, double a) {
  if (x1 == 0.0 || x2 == 0.0) return x1 + (x2 - x1) * a;
  return x1 * std::pow(x2 / x1, a);
}

int64_t amerge_walk(
    const double* zmdl_in, const double* pm, const double* tm,
    const double* rfndx, int64_t immax,
    const double* zout, int64_t ioutmx,
    double hmin, double tol,
    double* zpth, double* pp, double* tp, double* rf,
    int64_t* src_im, int64_t* src_jm, double* src_a,
    double* scal) {
  double hmid = scal[1];
  double* zmdl = new double[immax];
  std::memcpy(zmdl, zmdl_in, immax * sizeof(double));

  int64_t im = -1;
  for (int64_t i = 0; i < immax; ++i) {
    if (zmdl[i] >= hmin) { im = i; break; }
  }
  if (im < 0) { delete[] zmdl; return -1; }

  int64_t n = 0, iphmid = 0, iout = 0;
  const double ztop = zout[ioutmx - 1];
  for (;;) {
    if (im <= immax - 1 && iout <= ioutmx - 1) {
      if (std::fabs(zout[iout] - zmdl[im]) < tol) zmdl[im] = zout[iout];
    }
    if (im <= immax - 1 && (iout > ioutmx - 1 || zout[iout] >= zmdl[im])) {
      if (iout <= ioutmx - 1 && zout[iout] == zmdl[im]) ++iout;
      zpth[n] = zmdl[im];
      pp[n] = pm[im];
      tp[n] = tm[im];
      rf[n] = rfndx[im];
      src_im[n] = im;
      src_jm[n] = 0;
      src_a[n] = 0.0;
      ++n;
      ++im;
    } else {
      // model grid exhausted with zout points still above the snapped
      // top: fail loud (-2 -> wrapper raises), matching the Python
      // fallback's IndexError instead of reading zmdl[immax] OOB
      if (im > immax - 1) { delete[] zmdl; return -2; }
      const double z = zout[iout];
      const int64_t jm = im > 1 ? im : 1;
      const double a = (z - zmdl[jm - 1]) / (zmdl[jm] - zmdl[jm - 1]);
      zpth[n] = z;
      pp[n] = expint_c(pm[jm - 1], pm[jm], a);
      tp[n] = tm[jm - 1] + (tm[jm] - tm[jm - 1]) * a;
      rf[n] = expint_c(rfndx[jm - 1], rfndx[jm], a);
      src_im[n] = -1;
      src_jm[n] = jm;
      src_a[n] = a;
      ++n;
      ++iout;
    }
    if (std::fabs(zpth[n - 1] - hmid) < tol) {
      if (zpth[n - 1] != hmid) zpth[n - 1] = hmid;
      hmid = zpth[n - 1];
    }
    if (zpth[n - 1] == hmid) iphmid = n;  // 1-based
    if (std::fabs(zpth[n - 1] - ztop) < tol) zpth[n - 1] = ztop;
    if (zpth[n - 1] == ztop) break;
  }
  delete[] zmdl;
  scal[0] = (double)iphmid;
  scal[1] = hmid;
  return n;
}

}  // extern "C"
