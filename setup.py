from setuptools import setup, find_packages

setup(
    name="rafft_tpu",
    version="0.1.0",
    description="RNA fast-folding framework on JAX "
                "(FFT-based folding paths + kinetics)",
    packages=find_packages(include=["rafft_tpu", "rafft_tpu.*"]),
    scripts=["bin/rafft", "bin/rafft_kin"],
    python_requires=">=3.10",
    install_requires=["numpy", "scipy"],
    extras_require={
        "jax": ["jax"],
        "viz": ["matplotlib", "scikit-learn"],
    },
)
