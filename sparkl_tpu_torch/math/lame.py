"""Lamé parameter conversions. Ref: sparkl `src_core/utils/physics.rs:17-39`."""


def lame_lambda_mu(young_modulus, poisson_ratio):
    lam = (
        young_modulus
        * poisson_ratio
        / ((1.0 + poisson_ratio) * (1.0 - 2.0 * poisson_ratio))
    )
    return lam, shear_modulus(young_modulus, poisson_ratio)


def shear_modulus(young_modulus, poisson_ratio):
    return young_modulus / (2.0 * (1.0 + poisson_ratio))


def bulk_modulus(young_modulus, poisson_ratio):
    return young_modulus / (3.0 * (1.0 - 2.0 * poisson_ratio))


def shear_modulus_from_lame(lam, mu):
    return mu


def bulk_modulus_from_lame(lam, mu):
    return lam + 2.0 * mu / 3.0
