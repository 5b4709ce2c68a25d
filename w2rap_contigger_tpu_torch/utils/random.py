"""Random-number utilities mirroring the reference's src/random/.

The 7-step pipeline itself is deterministic (the reference never seeds
these on the assembly path), but the module rounds out the support
library surface:

  * RNGen — additive lagged-Fibonacci generator, lags (31, 28) over
    31 uint words, glibc-style seeding with a 310-step warmup; `next`
    returns a 31-bit value (src/random/RNGen.h:28-79, RNGen.cc);
  * randomx/randint/big_random (src/random/Random.h:15-23);
  * NormalDensity / StandardNormalDistributionIntegral /
    NormalDistributionIntegral / NormalDeviate
    (src/random/NormalDistribution.cc:14-76);
  * PartialBernoulliSum (src/random/Bernoulli.h:20).
"""

from __future__ import annotations

import math

import numpy as np

_MASK32 = 0xFFFFFFFF
STATE_SIZE = 31


class RNGen:
    """Additive lagged-Fibonacci PRNG (RNGen.h:28): state of 31 words;
    each step adds the rear word into the front word and emits the new
    front >> 1 (31 bits)."""

    def __init__(self, seed_val: int = 1):
        self.seed(seed_val)

    def seed(self, seed_val: int) -> None:
        state = [0] * STATE_SIZE
        last = seed_val & _MASK32
        state[0] = last
        for i in range(1, STATE_SIZE):
            last = (last * 1103515245 + 12345) & _MASK32
            state[i] = last
        self._state = state
        self._front = 3
        self._rear = 0
        for _ in range(10 * 31):
            self.next()

    def next(self) -> int:
        s = self._state
        s[self._front] = (s[self._front] + s[self._rear]) & _MASK32
        result = s[self._front]
        self._front += 1
        if self._front >= STATE_SIZE:
            self._front = 0
            self._rear += 1
        else:
            self._rear += 1
            if self._rear >= STATE_SIZE:
                self._rear = 0
        return result >> 1


_system = RNGen()


def srandomx(seed_val: int) -> None:
    _system.seed(seed_val)


def randomx() -> int:
    return _system.next()


def randint(u: int) -> int:
    return randomx() % u


def big_random() -> int:
    """62-bit random (Random.h:23): avoids the modulo bias of 31 bits."""
    return (randomx() << 31) | randomx()


# ---------------------------------------------------------------------------
# normal distribution (NormalDistribution.cc)
# ---------------------------------------------------------------------------


def normal_density(alpha: float, mu: float, sigma: float) -> float:
    assert sigma > 0
    const_part = 1.0 / (math.sqrt(2.0 * math.pi) * sigma)
    exp_part = -((alpha - mu) ** 2) / (2.0 * sigma * sigma)
    return const_part * math.exp(exp_part)


def standard_normal_distribution_integral(alpha: float) -> float:
    """CDF via the Numerical-Recipes erfc approximation the reference
    uses (NormalDistribution.cc:26-56)."""
    if alpha > 5:
        return 1.0
    if alpha < -5:
        return 0.0
    z = abs(alpha) / math.sqrt(2.0)
    t = 1.0 / (1.0 + 0.5 * z)
    ans = (
        0.5
        * t
        * math.exp(
            -z * z
            - 1.26551223
            + t
            * (1.00002368
               + t
               * (0.37409196
                  + t
                  * (0.09678418
                     + t
                     * (-0.18628806
                        + t
                        * (0.27886807
                           + t
                           * (-1.13520398
                              + t
                              * (1.48851587
                                 + t * (-0.82215223 + t * 0.17087277))))))))
        )
    )
    return 1.0 - ans if alpha >= 0.0 else ans


def normal_distribution_integral(alpha: float, mu: float, sigma: float) -> float:
    assert sigma > 0
    return standard_normal_distribution_integral((alpha - mu) / sigma)


def normal_deviate(U: float, V: float):
    """Ratio-of-uniforms accept/reject step (NormalDistribution.cc:63):
    returns (accepted, X)."""
    assert U > 0
    res = (math.sqrt(8.0 / math.e) * (V - 0.5)) / U
    if res * res <= -4.0 * math.log(U):
        return True, res
    return False, 0.0


def partial_bernoulli_sum(n: int, k: int) -> float:
    """sum_{i=0..k} choose(n, i) (Bernoulli.h:20)."""
    total = 0.0
    c = 1.0
    for i in range(k + 1):
        total += c
        c = c * (n - i) / (i + 1)
    return total
