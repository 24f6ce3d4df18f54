"""K6: the gathered row-dot of many-model serving, one warp per row in a
fixed order, so that a row's bits do not depend on the batch."""
