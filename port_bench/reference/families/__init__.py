"""One module per model family: `backbone(x, variables, prec)` on the
family's flax variables, and for a family whose weights can be drawn from
the seed, `layout(model)`: every leaf's path and shape."""
