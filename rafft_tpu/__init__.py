"""rafft_tpu — an RNA fast-folding framework on JAX.

A from-scratch reimplementation of the capabilities of lemerleau/RAFFT
(FFT-based RNA folding-path prediction + kinetic master-equation analysis),
re-designed for accelerator hardware: JAX/XLA compute path, integer Turner-2004
energy model (no ViennaRNA dependency), batched fixed-shape beam search,
and data-parallel sweeps over device meshes.

Public API (mirrors the reference 2-function surface,
/root/reference/rafft/__init__.py:1-2):

    fold(sequence, ...)      -> list[Structure]  (optionally + trajectory)
    kinetics(fast_paths, ..) -> (trajectory, times, struct_list, str_equi_pop)
"""

__version__ = "0.1.0"

__all__ = ["fold", "kinetics", "mfe_fold", "__version__"]


def __getattr__(name):
    # lazy re-exports keep `import rafft_tpu.energy` usable without pulling
    # the full engine (and JAX) into every process
    if name == "fold":
        from rafft_tpu.engine.fold_cpu import fold

        return fold
    if name == "kinetics":
        from rafft_tpu.kin.kinetics import kinetics

        return kinetics
    if name == "mfe_fold":
        # MFE baseline (the reference's RNA.fold role)
        from rafft_tpu.mfe import mfe_fold

        return mfe_fold
    raise AttributeError(name)
