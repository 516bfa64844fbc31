"""The reference's custom-kernel examples as user torch functions, each a
file that ``blocks.Kernel1To1``/``Kernel2To1`` can load by (filename,
kernelFnName), as the reference's blocks load their ``.cl`` files."""
