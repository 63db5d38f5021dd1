// Native runtime components of the PyTorch port (host C++, no CUDA).
//
// The port's compute path is its CUDA kernels and their plain PyTorch
// versions; this library is the host-side native runtime beside them:
//
//   1. an independent C++ RK4 oracle for CartPole and the 3D quadrotor
//      (through the PWM actuation map), float64: a third implementation
//      besides the engine under test and the NumPy oracle, used to
//      cross-check trajectories at double precision.  It shares no code
//      with csrc/ on purpose: an oracle earns its place by being
//      independent of the device path it checks;
//   2. a flight-log ring buffer with a CSV flush: the high-rate host-side
//      telemetry sink (the counterpart of the reference's Logger.py ring
//      arrays, envs/gym_pybullet_drones/Logger.py:9-416, without the
//      Python per-step overhead).
//
// The arithmetic and its order are those of the JAX package's own
// native/scg_native.cpp, so the same compiler and flags give the same
// bits.  Exposed through a plain C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

// ---------------------------------------------------------------------------
// Dynamics oracle
// ---------------------------------------------------------------------------

static const double G = 9.8;
static const double KF = 3.16e-10;
static const double KM = 7.94e-12;
static const double ARM_L = 0.0397;
static const double PWM2RPM_SCALE = 0.2685;
static const double PWM2RPM_CONST = 4070.3;
static const double MIN_PWM = 20000.0, MAX_PWM = 65535.0;

static void cartpole_fc(const double* x, double u, double pole_length,
                        double pole_mass, double cart_mass, double* dx) {
  const double l = pole_length / 2.0;
  const double Mm = cart_mass + pole_mass;
  const double ml = pole_mass * l;
  const double st = std::sin(x[2]), ct = std::cos(x[2]);
  const double temp = (u + ml * x[3] * x[3] * st) / Mm;
  const double theta_dd =
      (G * st - ct * temp) / (l * (4.0 / 3.0 - pole_mass * ct * ct / Mm));
  dx[0] = x[1];
  dx[1] = temp - ml * theta_dd * ct / Mm;
  dx[2] = x[3];
  dx[3] = theta_dd;
}

static void quad3d_fc(const double* x, const double* f, double mass,
                      const double* j, double* dx) {
  const double phi = x[6], theta = x[7], psi = x[8];
  const double p = x[9], q = x[10], r = x[11];
  const double T = f[0] + f[1] + f[2] + f[3];
  const double cphi = std::cos(phi), sphi = std::sin(phi);
  const double cth = std::cos(theta), sth = std::sin(theta);
  const double cpsi = std::cos(psi), spsi = std::sin(psi);
  // Body z-axis in world frame (same closed form as the engine).
  const double zb0 = cpsi * sth * cphi + spsi * sphi;
  const double zb1 = spsi * sth * cphi - cpsi * sphi;
  const double zb2 = cth * cphi;
  dx[0] = x[1];
  dx[1] = zb0 * T / mass;
  dx[2] = x[3];
  dx[3] = zb1 * T / mass;
  dx[4] = x[5];
  dx[5] = zb2 * T / mass - G;
  const double l2 = ARM_L / std::sqrt(2.0);
  const double Mx = l2 * (f[0] + f[1] - f[2] - f[3]);
  const double My = l2 * (-f[0] + f[1] + f[2] - f[3]);
  const double Mz = (KM / KF) * (f[0] - f[1] + f[2] - f[3]);
  // omega x (J omega)
  const double gx = q * (j[2] * r) - r * (j[1] * q);
  const double gy = r * (j[0] * p) - p * (j[2] * r);
  const double gz = p * (j[1] * q) - q * (j[0] * p);
  dx[9] = (Mx - gx) / j[0];
  dx[10] = (My - gy) / j[1];
  dx[11] = (Mz - gz) / j[2];
  const double tth = std::tan(theta);
  dx[6] = p + sphi * tth * q + cphi * tth * r;
  dx[7] = cphi * q - sphi * r;
  dx[8] = sphi / cth * q + cphi / cth * r;
}

template <int NX, typename F>
static void rk4(F fc, double* x, double dt) {
  double k1[NX], k2[NX], k3[NX], k4[NX], tmp[NX];
  fc(x, k1);
  for (int i = 0; i < NX; i++) tmp[i] = x[i] + dt / 2 * k1[i];
  fc(tmp, k2);
  for (int i = 0; i < NX; i++) tmp[i] = x[i] + dt / 2 * k2[i];
  fc(tmp, k3);
  for (int i = 0; i < NX; i++) tmp[i] = x[i] + dt * k3[i];
  fc(tmp, k4);
  for (int i = 0; i < NX; i++)
    x[i] = x[i] + dt / 6 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]);
}

extern "C" {

// CartPole rollout: forces (T,), out (T+1, 4).
void scg_cartpole_rollout(const double* x0, const double* forces, int T,
                          int n_sub, double dt, double pole_length,
                          double pole_mass, double cart_mass, double* out) {
  double x[4];
  std::memcpy(x, x0, sizeof(x));
  std::memcpy(out, x, sizeof(x));
  for (int t = 0; t < T; t++) {
    const double u = forces[t];
    auto fc = [&](const double* xx, double* dd) {
      cartpole_fc(xx, u, pole_length, pole_mass, cart_mass, dd);
    };
    for (int s = 0; s < n_sub; s++) rk4<4>(fc, x, dt);
    std::memcpy(out + (t + 1) * 4, x, sizeof(x));
  }
}

// thrust command -> 4 motor forces through the PWM pipeline.
void scg_thrust_to_forces(const double* thrust, int nu, double* forces) {
  const int n_motor = 4 / nu;
  double pwm[4];
  for (int i = 0; i < nu; i++) {
    double th = thrust[i] < 0 ? 0 : thrust[i];
    double p = (std::sqrt(th / n_motor / KF) - PWM2RPM_CONST) / PWM2RPM_SCALE;
    pwm[i] = p;
  }
  if (nu == 1) {
    pwm[1] = pwm[2] = pwm[3] = pwm[0];
  } else if (nu == 2) {
    pwm[2] = pwm[1];
    pwm[3] = pwm[0];
  }
  for (int i = 0; i < 4; i++) {
    double p = pwm[i] < MIN_PWM ? MIN_PWM : (pwm[i] > MAX_PWM ? MAX_PWM : pwm[i]);
    double rpm = PWM2RPM_SCALE * p + PWM2RPM_CONST;
    forces[i] = KF * rpm * rpm;
  }
}

// Quadrotor 3D rollout: thrusts (T, 4) commanded per-motor thrusts,
// out (T+1, 12).
void scg_quad3d_rollout(const double* x0, const double* thrusts, int T,
                        int n_sub, double dt, double mass, const double* j,
                        double* out) {
  double x[12];
  std::memcpy(x, x0, sizeof(x));
  std::memcpy(out, x, sizeof(x));
  for (int t = 0; t < T; t++) {
    double f[4];
    scg_thrust_to_forces(thrusts + t * 4, 4, f);
    auto fc = [&](const double* xx, double* dd) { quad3d_fc(xx, f, mass, j, dd); };
    for (int s = 0; s < n_sub; s++) rk4<12>(fc, x, dt);
    std::memcpy(out + (t + 1) * 12, x, sizeof(x));
  }
}

// ---------------------------------------------------------------------------
// Flight-log ring buffer
// ---------------------------------------------------------------------------

struct ScgLogger {
  std::vector<double> data;  // capacity * width
  int64_t capacity = 0;
  int64_t width = 0;
  int64_t head = 0;   // next write slot
  int64_t count = 0;  // total records written (may exceed capacity)
};

void* scg_logger_create(int64_t capacity, int64_t width) {
  ScgLogger* lg = new ScgLogger();
  lg->capacity = capacity;
  lg->width = width;
  lg->data.resize(capacity * width);
  return lg;
}

void scg_logger_destroy(void* h) { delete static_cast<ScgLogger*>(h); }

void scg_logger_append(void* h, const double* record, int64_t n_records) {
  ScgLogger* lg = static_cast<ScgLogger*>(h);
  for (int64_t r = 0; r < n_records; r++) {
    std::memcpy(lg->data.data() + lg->head * lg->width, record + r * lg->width,
                lg->width * sizeof(double));
    lg->head = (lg->head + 1) % lg->capacity;
    lg->count++;
  }
}

int64_t scg_logger_count(void* h) {
  return static_cast<ScgLogger*>(h)->count;
}

// Copy the last min(count, capacity) records, oldest first, into out.
int64_t scg_logger_snapshot(void* h, double* out) {
  ScgLogger* lg = static_cast<ScgLogger*>(h);
  int64_t n = lg->count < lg->capacity ? lg->count : lg->capacity;
  int64_t start = lg->count < lg->capacity ? 0 : lg->head;
  for (int64_t i = 0; i < n; i++) {
    int64_t src = (start + i) % lg->capacity;
    std::memcpy(out + i * lg->width, lg->data.data() + src * lg->width,
                lg->width * sizeof(double));
  }
  return n;
}

int scg_logger_flush_csv(void* h, const char* path, const char* header) {
  ScgLogger* lg = static_cast<ScgLogger*>(h);
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  if (header && header[0]) std::fprintf(f, "%s\n", header);
  int64_t n = lg->count < lg->capacity ? lg->count : lg->capacity;
  int64_t start = lg->count < lg->capacity ? 0 : lg->head;
  for (int64_t i = 0; i < n; i++) {
    const double* rec = lg->data.data() + ((start + i) % lg->capacity) * lg->width;
    for (int64_t c = 0; c < lg->width; c++)
      std::fprintf(f, c + 1 == lg->width ? "%.17g\n" : "%.17g,", rec[c]);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
