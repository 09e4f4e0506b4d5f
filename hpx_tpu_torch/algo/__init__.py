"""Parallel algorithms on one device.

Reference analog: libs/core/algorithms — the CPO set over execution
policies. Counterpart of ``hpx_tpu.algo`` for its elementwise and
reduction submodules; scans, set operations, sorting, the FFT and the
segmented overlay (over ``partitioned_vector``) are not ported yet.
"""

from . import elementwise as _ew
from . import reductions as _red

# -- elementwise (shape-preserving) ------------------------------------------
for_each = _ew.for_each
for_each_n = _ew.for_each_n
for_loop = _ew.for_loop
transform = _ew.transform
copy = _ew.copy
copy_n = _ew.copy_n
copy_if = _ew.copy_if
fill = _ew.fill
fill_n = _ew.fill_n
generate = _ew.generate
generate_n = _ew.generate_n
remove = _ew.remove
remove_if = _ew.remove_if
replace = _ew.replace
replace_if = _ew.replace_if

# -- reductions / searches (scalar results) ----------------------------------
reduce = _red.reduce
transform_reduce = _red.transform_reduce
count = _red.count
count_if = _red.count_if
all_of = _red.all_of
any_of = _red.any_of
none_of = _red.none_of
min_element = _red.min_element
max_element = _red.max_element
minmax_element = _red.minmax_element
equal = _red.equal
mismatch = _red.mismatch
find = _red.find
find_if = _red.find_if
find_first_of = _red.find_first_of
is_sorted_until = _red.is_sorted_until
is_partitioned = _red.is_partitioned
lexicographical_compare = _red.lexicographical_compare
reduce_by_key = _red.reduce_by_key
search = _red.search
search_n = _red.search_n
find_end = _red.find_end
contains = _red.contains
contains_subrange = _red.contains_subrange
starts_with = _red.starts_with
ends_with = _red.ends_with

# functional-data-model aliases, as the reference's: where the target
# already returns a NEW range (remove compacts, copy copies) the *_copy
# variant IS the in-place sibling, and std::move degenerates to copy.
# replace/replace_if mutate on the host path (std semantics), so their
# _copy variants are real copy-first wrappers.
remove_copy = remove
remove_copy_if = remove_if
replace_copy = _ew.replace_copy
replace_copy_if = _ew.replace_copy_if
move = copy

# for_loop clause objects (hpx::experimental::induction/reduction)
induction = _ew.induction
reduction = _ew.reduction
Induction = _ew.Induction
Reduction = _ew.Reduction

__all__ = [
    "induction", "reduction", "Induction", "Reduction",
    "for_each", "for_each_n", "for_loop", "transform", "copy", "copy_n",
    "copy_if", "fill", "fill_n", "generate", "generate_n",
    "reduce", "transform_reduce", "count", "count_if",
    "all_of", "any_of", "none_of", "min_element", "max_element",
    "minmax_element", "equal", "mismatch", "find", "find_if",
    "find_first_of", "is_sorted_until", "is_partitioned",
    "lexicographical_compare", "remove", "remove_if", "replace",
    "replace_if", "search", "search_n", "find_end", "contains",
    "contains_subrange", "starts_with", "ends_with",
    "remove_copy", "remove_copy_if", "replace_copy", "replace_copy_if",
    "move", "reduce_by_key",
]
