"""Parallel algorithms (local + segmented surface).

Reference analog: libs/core/algorithms — the CPO set over execution
policies — plus libs/full/segmented_algorithms: the SAME entry points
accept partitioned_vector arguments and dispatch the segmented overlay
(segmented.py), exactly as HPX routes segmented iterators through
segmented_iterator_traits. `preserves_shape` marks the algorithms whose
result is a same-length range (rewrapped in the source's layout).
Counterpart of ``hpx_tpu.algo``, every name of its ``__all__``. A
partitioned_vector over more than one rank goes through the overlay's
four classes (local, combine, sort, gather; segmented.py), and
``sort_sharded`` / ``sort_sharded_by_key`` are the explicit distributed
surface: each rank passes its chunk of a vector laid out over a mesh
axis (sorting.py).
"""

from . import elementwise as _ew
from . import fft  # noqa: F401  (mesh-array surface, not a CPO)
from . import reductions as _red
from . import scans as _sc
from . import setops as _set
from . import sorting as _so
from .segmented import segmentable as _seg

# -- elementwise (shape-preserving) ------------------------------------------
for_each = _seg(_ew.for_each, preserves_shape=True)
for_each_n = _seg(_ew.for_each_n)
for_loop = _seg(_ew.for_loop)
transform = _seg(_ew.transform, preserves_shape=True)
copy = _seg(_ew.copy, preserves_shape=True)
copy_n = _seg(_ew.copy_n)
copy_if = _seg(_ew.copy_if)
fill = _seg(_ew.fill, preserves_shape=True)
fill_n = _seg(_ew.fill_n)
generate = _seg(_ew.generate, preserves_shape=True)
generate_n = _seg(_ew.generate_n)
remove = _seg(_ew.remove)
remove_if = _seg(_ew.remove_if)
replace = _seg(_ew.replace, preserves_shape=True)
replace_if = _seg(_ew.replace_if, preserves_shape=True)

# -- reductions / searches (scalar results) ----------------------------------
reduce = _seg(_red.reduce)
transform_reduce = _seg(_red.transform_reduce)
count = _seg(_red.count)
count_if = _seg(_red.count_if)
all_of = _seg(_red.all_of)
any_of = _seg(_red.any_of)
none_of = _seg(_red.none_of)
min_element = _seg(_red.min_element)
max_element = _seg(_red.max_element)
minmax_element = _seg(_red.minmax_element)
equal = _seg(_red.equal)
mismatch = _seg(_red.mismatch)
find = _seg(_red.find)
find_if = _seg(_red.find_if)
find_first_of = _seg(_red.find_first_of)
is_sorted_until = _seg(_red.is_sorted_until)
is_partitioned = _seg(_red.is_partitioned)
lexicographical_compare = _seg(_red.lexicographical_compare)
reduce_by_key = _seg(_red.reduce_by_key)
search = _seg(_red.search)
search_n = _seg(_red.search_n)
find_end = _seg(_red.find_end)
contains = _seg(_red.contains)
contains_subrange = _seg(_red.contains_subrange)
starts_with = _seg(_red.starts_with)
ends_with = _seg(_red.ends_with)

# -- set operations on sorted ranges (data-dependent output sizes) -----------
set_union = _seg(_set.set_union)
set_intersection = _seg(_set.set_intersection)
set_difference = _seg(_set.set_difference)
set_symmetric_difference = _seg(_set.set_symmetric_difference)
includes = _seg(_set.includes)

# -- scans (shape-preserving) ------------------------------------------------
inclusive_scan = _seg(_sc.inclusive_scan, preserves_shape=True)
exclusive_scan = _seg(_sc.exclusive_scan, preserves_shape=True)
transform_inclusive_scan = _seg(_sc.transform_inclusive_scan,
                                preserves_shape=True)
transform_exclusive_scan = _seg(_sc.transform_exclusive_scan,
                                preserves_shape=True)
adjacent_difference = _seg(_sc.adjacent_difference, preserves_shape=True)
adjacent_find = _seg(_sc.adjacent_find)

# -- sorting / permutations --------------------------------------------------
sort = _seg(_so.sort, preserves_shape=True)
sort_sharded = _so.sort_sharded        # explicit distributed surface
sort_sharded_by_key = _so.sort_sharded_by_key
stable_sort = _seg(_so.stable_sort, preserves_shape=True)
is_sorted = _seg(_so.is_sorted)
merge = _seg(_so.merge)
reverse = _seg(_so.reverse, preserves_shape=True)
rotate = _seg(_so.rotate, preserves_shape=True)
unique = _seg(_so.unique)
partition = _seg(_so.partition)
partition_copy = _seg(_so.partition_copy)
is_heap = _seg(_so.is_heap)
is_heap_until = _seg(_so.is_heap_until)
partial_sort = _seg(_so.partial_sort, preserves_shape=True)
partial_sort_copy = _seg(_so.partial_sort_copy)
nth_element = _seg(_so.nth_element, preserves_shape=True)
shift_left = _seg(_so.shift_left, preserves_shape=True)
shift_right = _seg(_so.shift_right, preserves_shape=True)
swap_ranges = _so.swap_ranges          # pair-valued: no segmented overlay

# functional-data-model aliases: where the target already returns a NEW
# range (remove/unique compact, copy copies) the *_copy variant IS the
# in-place sibling, and std::move degenerates to copy. replace/replace_if
# mutate on the host path (std semantics), so their _copy variants are
# real copy-first wrappers (hpx/parallel/algorithms/{unique,remove_copy,
# replace_copy,move}.hpp surface).
unique_copy = unique
remove_copy = remove
remove_copy_if = remove_if
replace_copy = _seg(_ew.replace_copy, preserves_shape=True)
replace_copy_if = _seg(_ew.replace_copy_if, preserves_shape=True)
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
    "replace_if",
    "inclusive_scan", "exclusive_scan", "transform_inclusive_scan",
    "transform_exclusive_scan", "adjacent_difference", "adjacent_find",
    "sort", "sort_sharded", "sort_sharded_by_key", "stable_sort", "is_sorted", "merge",
    "reverse", "rotate", "unique", "partition",
    "search", "search_n", "find_end", "contains", "contains_subrange",
    "starts_with", "ends_with",
    "set_union", "set_intersection", "set_difference",
    "set_symmetric_difference", "includes",
    "partition_copy", "partial_sort", "partial_sort_copy", "nth_element",
    "is_heap", "is_heap_until",
    "shift_left", "shift_right", "swap_ranges",
    "unique_copy", "remove_copy", "remove_copy_if", "replace_copy",
    "replace_copy_if", "move", "reduce_by_key",
]
