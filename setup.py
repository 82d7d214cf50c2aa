from setuptools import find_packages, setup

setup(
    name="ntlink-jax",
    version="0.1.0",
    description="Long-read genome scaffolding on the GPU (JAX/XLA)",
    packages=find_packages(include=["ntlink_jax", "ntlink_jax.*"]),
    package_data={"ntlink_jax.native": ["*.c"]},
    python_requires=">=3.10",
    install_requires=["numpy"],
    extras_require={"gpu": ["jax[cuda12]"]},
    entry_points={"console_scripts": ["ntlink=ntlink_jax.cli:main"]},
)
