"""Background-grid backends: dense logical grids and block-sparse tile grids."""

from hot_mpm.grid.sparse import TileGrid, build_tile_grid, sparse_stencil  # noqa: F401
