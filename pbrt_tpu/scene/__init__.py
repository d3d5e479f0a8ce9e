"""Scene layer: SoA geometry/light/material tables + host-side builders.

JAX counterpart of the reference's L2/L3 plugin families
(src/shapes/, src/lights/, src/materials/, src/accelerators/ — SURVEY.md §2).
The virtual-dispatch object graph becomes typed arrays + integer tags;
intersection and sampling are batched over rays.
"""
