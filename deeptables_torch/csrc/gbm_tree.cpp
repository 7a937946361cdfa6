// One regression tree grown exactly as scikit-learn 1.9.0's
// DecisionTreeRegressor(criterion="squared_error", splitter="best") grows
// it on dense float32 inputs, plus the per-sample pieces of its gradient
// boosting that scikit-learn computes in C (the losses, their gradients and
// links, the subsample mask) and its minimal cost-complexity pruning. Host
// code, built with the host compiler and loaded with ctypes by
// models/gbm.py.
//
// Each part follows its scikit-learn source line for line, because the
// trees depend on the order of floating-point sums and of swaps:
//   simultaneous_sort        sklearn/utils/_sorting.pyx (3-way introsort)
//   Partitioner              sklearn/tree/_partitioner.pyx DensePartitioner
//   node_split_best          sklearn/tree/_splitter.pyx
//   Criterion                sklearn/tree/_criterion.pyx MSE
//   rand_int, our_rand_r     sklearn/tree/_utils.pyx, utils/_random.pxd
//   build_depth_first        sklearn/tree/_tree.pyx DepthFirstTreeBuilder
//   build_best_first         sklearn/tree/_tree.pyx BestFirstTreeBuilder
//   tree_apply               sklearn/tree/_tree.pyx Tree._apply_dense
//   tree_prune               sklearn/tree/_tree.pyx _cost_complexity_prune,
//                            _AlphaPruner, _build_pruned_tree
//   neg_gradient_*, loss     sklearn/_loss/_loss.pyx.tp
//   logit                    scipy's xsf logit (scipy.special.logit)
//   sample_mask              sklearn/ensemble/_gradient_boosting.pyx
// Missing values in the inputs are refused by the caller, as scikit-learn's
// gradient boosting refuses them, so the splitter's missing-value passes
// are left out; apply still routes NaN as Tree.apply does.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stack>
#include <vector>

namespace {

typedef int64_t intp;

const float FEATURE_THRESHOLD = 1e-7f;
const uint32_t RAND_R_MAX = 2147483647u;
const uint32_t DEFAULT_SEED = 1u;
const double EPSILON = DBL_EPSILON;
const intp TREE_LEAF = -1;
const intp TREE_UNDEFINED = -2;

// -- random numbers ---------------------------------------------------------

inline uint32_t our_rand_r(uint32_t* seed) {
    if (seed[0] == 0) seed[0] = DEFAULT_SEED;
    seed[0] ^= (uint32_t)(seed[0] << 13);
    seed[0] ^= (uint32_t)(seed[0] >> 17);
    seed[0] ^= (uint32_t)(seed[0] << 5);
    return seed[0] % (RAND_R_MAX + 1u);
}

inline intp rand_int(intp low, intp high, uint32_t* state) {
    return low + (intp)our_rand_r(state) % (high - low);
}

// -- simultaneous_sort, use_three_way_partition=True ------------------------

inline void swap2(float* values, intp* indices, intp i, intp j) {
    std::swap(values[i], values[j]);
    std::swap(indices[i], indices[j]);
}

inline float median3(const float* v, intp n) {
    float a = v[0], b = v[n / 2], c = v[n - 1];
    if (a < b) {
        if (b < c) return b;
        else if (a < c) return c;
        else return a;
    } else if (b < c) {
        if (a < c) return a;
        else return c;
    } else {
        return b;
    }
}

void insertion_sort(float* values, intp* indices, intp n) {
    for (intp i = 1; i < n; ++i) {
        float temp_val = values[i];
        intp temp_idx = indices[i];
        intp j = i;
        while (j > 0 && values[j - 1] > temp_val) {
            values[j] = values[j - 1];
            indices[j] = indices[j - 1];
            --j;
        }
        values[j] = temp_val;
        indices[j] = temp_idx;
    }
}

inline void sift_down(float* v, intp* s, intp start, intp end) {
    intp root = start;
    while (true) {
        intp child = root * 2 + 1;
        intp maxind = root;
        if (child < end && v[maxind] < v[child]) maxind = child;
        if (child + 1 < end && v[maxind] < v[child + 1]) maxind = child + 1;
        if (maxind == root) break;
        swap2(v, s, root, maxind);
        root = maxind;
    }
}

void heapsort(float* v, intp* s, intp n) {
    intp start = (n - 2) / 2;
    intp end = n;
    while (true) {
        sift_down(v, s, start, end);
        if (start == 0) break;
        --start;
    }
    end = n - 1;
    while (end > 0) {
        swap2(v, s, 0, end);
        sift_down(v, s, 0, end);
        end = end - 1;
    }
}

void introsort_3way(float* values, intp* indices, intp n, intp maxd) {
    while (n > 15) {
        if (maxd <= 0) {
            heapsort(values, indices, n);
            return;
        }
        --maxd;
        float pivot = median3(values, n);
        intp i = 0, l = 0, r = n;
        while (i < r) {
            if (values[i] < pivot) {
                swap2(values, indices, i, l);
                ++i;
                ++l;
            } else if (values[i] > pivot) {
                --r;
                swap2(values, indices, i, r);
            } else {
                ++i;
            }
        }
        introsort_3way(values, indices, l, maxd);
        values += r;
        indices += r;
        n -= r;
    }
    insertion_sort(values, indices, n);
}

void simultaneous_sort(float* values, intp* indices, intp n) {
    if (n == 0) return;
    intp maxd = 2 * (intp)std::log2((double)n);
    introsort_3way(values, indices, n, maxd);
}

// -- the criterion: RegressionCriterion / MSE with one output ---------------

struct Criterion {
    const double* y = nullptr;
    const double* sample_weight = nullptr;
    const intp* sample_indices = nullptr;
    intp start = 0, pos = 0, end = 0;
    double weighted_n_samples = 0.0;
    double weighted_n_node_samples = 0.0;
    double weighted_n_left = 0.0, weighted_n_right = 0.0;
    double sq_sum_total = 0.0;
    double sum_total = 0.0, sum_left = 0.0, sum_right = 0.0;

    void init(const double* y_, const double* sw, double wns,
              const intp* indices, intp start_, intp end_) {
        y = y_;
        sample_weight = sw;
        sample_indices = indices;
        start = start_;
        end = end_;
        weighted_n_samples = wns;
        weighted_n_node_samples = 0.0;
        sq_sum_total = 0.0;
        sum_total = 0.0;
        for (intp p = start; p < end; ++p) {
            intp i = sample_indices[p];
            double w = sample_weight[i];
            double y_ik = y[i];
            double w_y_ik = w * y_ik;
            sum_total += w_y_ik;
            sq_sum_total += w_y_ik * y_ik;
            weighted_n_node_samples += w;
        }
        reset();
    }

    void reset() {
        pos = start;
        sum_left = 0.0;
        sum_right = sum_total;
        weighted_n_left = 0.0;
        weighted_n_right = weighted_n_node_samples;
    }

    void reverse_reset() {
        pos = end;
        sum_right = 0.0;
        sum_left = sum_total;
        weighted_n_right = 0.0;
        weighted_n_left = weighted_n_node_samples;
    }

    void update(intp new_pos) {
        if ((new_pos - pos) <= (end - new_pos)) {
            for (intp p = pos; p < new_pos; ++p) {
                intp i = sample_indices[p];
                double w = sample_weight[i];
                sum_left += w * y[i];
                weighted_n_left += w;
            }
        } else {
            reverse_reset();
            for (intp p = end - 1; p > new_pos - 1; --p) {
                intp i = sample_indices[p];
                double w = sample_weight[i];
                sum_left -= w * y[i];
                weighted_n_left -= w;
            }
        }
        weighted_n_right = weighted_n_node_samples - weighted_n_left;
        sum_right = sum_total - sum_left;
        pos = new_pos;
    }

    double node_impurity() const {
        double impurity = sq_sum_total / weighted_n_node_samples;
        impurity -= std::pow(sum_total / weighted_n_node_samples, 2.0);
        return impurity / 1;
    }

    double proxy_impurity_improvement() const {
        double proxy_left = 0.0, proxy_right = 0.0;
        proxy_left += sum_left * sum_left;
        proxy_right += sum_right * sum_right;
        return proxy_left / weighted_n_left + proxy_right / weighted_n_right;
    }

    void children_impurity(double* impurity_left,
                           double* impurity_right) const {
        double sq_sum_left = 0.0;
        for (intp p = start; p < pos; ++p) {
            intp i = sample_indices[p];
            double w = sample_weight[i];
            double y_ik = y[i];
            sq_sum_left += w * y_ik * y_ik;
        }
        double sq_sum_right = sq_sum_total - sq_sum_left;
        impurity_left[0] = sq_sum_left / weighted_n_left;
        impurity_right[0] = sq_sum_right / weighted_n_right;
        impurity_left[0] -= std::pow(sum_left / weighted_n_left, 2.0);
        impurity_right[0] -= std::pow(sum_right / weighted_n_right, 2.0);
        impurity_left[0] /= 1;
        impurity_right[0] /= 1;
    }

    double impurity_improvement(double impurity_parent, double impurity_left,
                                double impurity_right) const {
        return ((weighted_n_node_samples / weighted_n_samples) *
                (impurity_parent - (weighted_n_right /
                                    weighted_n_node_samples * impurity_right)
                                 - (weighted_n_left /
                                    weighted_n_node_samples * impurity_left)));
    }

    double node_value() const {
        return sum_total / weighted_n_node_samples;
    }
};

// -- the splitter: BestSplitter over a DensePartitioner ---------------------

struct SplitRecord {
    intp feature;
    intp pos;
    double threshold;
    double improvement;
    double impurity_left;
    double impurity_right;
    bool missing_go_to_left;
};

inline void init_split(SplitRecord* s, intp start_pos) {
    s->impurity_left = INFINITY;
    s->impurity_right = INFINITY;
    s->pos = start_pos;
    s->feature = 0;
    s->threshold = 0.;
    s->improvement = -INFINITY;
    s->missing_go_to_left = false;
}

struct ParentInfo {
    double impurity = INFINITY;
    intp n_constant_features = 0;
};

struct Splitter {
    const float* X;  // n_total x n_features, C order
    intp n_total;
    intp n_features;
    const double* y;
    const double* sample_weight;
    intp max_features;
    intp min_samples_leaf;
    double min_weight_leaf;
    uint32_t rand_r_state;

    std::vector<intp> samples;
    intp n_samples = 0;
    double weighted_n_samples = 0.0;
    std::vector<intp> features;
    std::vector<intp> constant_features;
    std::vector<float> feature_values;
    intp start = 0, end = 0;
    Criterion criterion;

    inline float x(intp sample, intp feature) const {
        return X[sample * n_features + feature];
    }

    void init() {
        samples.assign(n_total, 0);
        intp j = 0;
        double wns = 0.0;
        for (intp i = 0; i < n_total; ++i) {
            if (sample_weight[i] != 0.0) samples[j++] = i;
            wns += sample_weight[i];
        }
        n_samples = j;
        weighted_n_samples = wns;
        features.resize(n_features);
        for (intp f = 0; f < n_features; ++f) features[f] = f;
        feature_values.assign(n_total, 0.0f);
        constant_features.assign(n_features, 0);
    }

    void node_reset(intp start_, intp end_, double* weighted_n_node_samples) {
        start = start_;
        end = end_;
        criterion.init(y, sample_weight, weighted_n_samples, samples.data(),
                       start, end);
        weighted_n_node_samples[0] = criterion.weighted_n_node_samples;
    }

    void sort_samples_and_feature_values(intp current_feature) {
        for (intp i = start; i < end; ++i)
            feature_values[i] = x(samples[i], current_feature);
        simultaneous_sort(&feature_values[start], &samples[start],
                          end - start);
    }

    void next_p(intp* p_prev, intp* p) {
        intp end_non_missing = end;
        p[0] += 1;
        while (p[0] < end_non_missing &&
               feature_values[p[0]] <= feature_values[p[0] - 1] +
                                          FEATURE_THRESHOLD)
            p[0] += 1;
        p_prev[0] = p[0] - 1;
    }

    void partition_samples_final(const SplitRecord* best) {
        intp partition_start = start, partition_end = end;
        intp* s = samples.data();
        double best_threshold = best->threshold;
        intp best_feature = best->feature;
        while (partition_start < partition_end) {
            float current_value = x(s[partition_start], best_feature);
            bool go_to_left = current_value <= best_threshold;
            if (go_to_left) {
                partition_start += 1;
            } else {
                partition_end -= 1;
                std::swap(s[partition_start], s[partition_end]);
            }
        }
    }

    void node_split(ParentInfo* parent_record, SplitRecord* split) {
        SplitRecord best_split, current_split;
        double current_proxy_improvement = -INFINITY;
        double best_proxy_improvement = -INFINITY;
        double impurity = parent_record->impurity;

        intp f_i = n_features;
        intp f_j, p, p_prev = 0;
        intp n_visited_features = 0;
        intp n_found_constants = 0;
        intp n_drawn_constants = 0;
        intp n_known_constants = parent_record->n_constant_features;
        intp n_total_constants = n_known_constants;

        init_split(&best_split, end);
        current_split = best_split;

        while (f_i > n_total_constants &&
               (n_visited_features < max_features ||
                n_visited_features <= n_found_constants + n_drawn_constants)) {
            n_visited_features += 1;
            f_j = rand_int(n_drawn_constants, f_i - n_found_constants,
                           &rand_r_state);
            if (f_j < n_known_constants) {
                std::swap(features[n_drawn_constants], features[f_j]);
                n_drawn_constants += 1;
                continue;
            }
            f_j += n_found_constants;
            current_split.feature = features[f_j];
            sort_samples_and_feature_values(current_split.feature);
            intp end_non_missing = end;
            if (end_non_missing == start ||
                feature_values[end_non_missing - 1] <=
                    feature_values[start] + FEATURE_THRESHOLD) {
                std::swap(features[f_j], features[n_total_constants]);
                n_found_constants += 1;
                n_total_constants += 1;
                continue;
            }
            f_i -= 1;
            std::swap(features[f_i], features[f_j]);

            criterion.reset();
            p = start;
            while (p < end) {
                next_p(&p_prev, &p);
                if (p == end) continue;
                intp n_left = p - start;
                intp n_right = end - p;
                if (n_left < min_samples_leaf || n_right < min_samples_leaf)
                    continue;
                current_split.pos = p;
                criterion.update(current_split.pos);
                if (criterion.weighted_n_left < min_weight_leaf ||
                    criterion.weighted_n_right < min_weight_leaf)
                    continue;
                current_proxy_improvement =
                    criterion.proxy_impurity_improvement();
                if (current_proxy_improvement > best_proxy_improvement) {
                    best_proxy_improvement = current_proxy_improvement;
                    current_split.threshold =
                        (double)feature_values[p_prev] / 2.0 +
                        (double)feature_values[p] / 2.0;
                    current_split.missing_go_to_left = n_left > n_right;
                    best_split = current_split;
                }
            }
        }

        if (best_split.pos < end) {
            partition_samples_final(&best_split);
            criterion.reset();
            criterion.update(best_split.pos);
            criterion.children_impurity(&best_split.impurity_left,
                                        &best_split.impurity_right);
            best_split.improvement = criterion.impurity_improvement(
                impurity, best_split.impurity_left,
                best_split.impurity_right);
        }

        std::memcpy(features.data(), constant_features.data(),
                    sizeof(intp) * n_known_constants);
        std::memcpy(constant_features.data() + n_known_constants,
                    features.data() + n_known_constants,
                    sizeof(intp) * n_found_constants);

        parent_record->n_constant_features = n_total_constants;
        split[0] = best_split;
    }
};

// -- the tree ---------------------------------------------------------------

struct TreeOut {
    intp capacity;
    intp node_count;
    intp* left;
    intp* right;
    intp* feature;
    double* threshold;
    uint8_t* missing_go_to_left;
    double* value;
    double* impurity;
    double* weighted_n_node_samples;

    // Tree._add_node; -1 when the caller's arrays are too small
    intp add_node(intp parent, bool is_left, bool is_leaf, intp feat,
                  double thresh, bool mgl, double node_impurity,
                  double node_weight) {
        intp node_id = node_count;
        if (node_id >= capacity) return -1;
        impurity[node_id] = node_impurity;
        weighted_n_node_samples[node_id] = node_weight;
        if (parent != TREE_UNDEFINED) {
            if (is_left) left[parent] = node_id;
            else right[parent] = node_id;
        }
        if (is_leaf) {
            left[node_id] = TREE_LEAF;
            right[node_id] = TREE_LEAF;
            feature[node_id] = TREE_UNDEFINED;
            threshold[node_id] = TREE_UNDEFINED;
            missing_go_to_left[node_id] = 0;
        } else {
            left[node_id] = TREE_UNDEFINED;
            right[node_id] = TREE_UNDEFINED;
            feature[node_id] = feat;
            threshold[node_id] = thresh;
            missing_go_to_left[node_id] = mgl;
        }
        node_count += 1;
        return node_id;
    }
};

struct StackRecord {
    intp start, end, depth, parent;
    bool is_left;
    double impurity;
    intp n_constant_features;
};

intp build_depth_first(Splitter& splitter, TreeOut& tree,
                       intp min_samples_split, intp min_samples_leaf,
                       double min_weight_leaf, intp max_depth,
                       double min_impurity_decrease) {
    std::stack<StackRecord> stack;
    ParentInfo parent_record;
    SplitRecord split;
    init_split(&split, 0);
    bool first = true;
    stack.push({0, splitter.n_samples, 0, TREE_UNDEFINED, false,
                        INFINITY, 0});
    while (!stack.empty()) {
        StackRecord rec = stack.top();
        stack.pop();
        intp start = rec.start, end = rec.end, depth = rec.depth;
        parent_record.impurity = rec.impurity;
        parent_record.n_constant_features = rec.n_constant_features;

        intp n_node_samples = end - start;
        double weighted_n_node_samples;
        splitter.node_reset(start, end, &weighted_n_node_samples);

        bool is_leaf = (depth >= max_depth ||
                        n_node_samples < min_samples_split ||
                        n_node_samples < 2 * min_samples_leaf ||
                        weighted_n_node_samples < 2 * min_weight_leaf);
        if (first) {
            parent_record.impurity = splitter.criterion.node_impurity();
            first = false;
        }
        is_leaf = is_leaf || parent_record.impurity <= EPSILON;
        if (!is_leaf) {
            splitter.node_split(&parent_record, &split);
            is_leaf = (is_leaf || split.pos >= end ||
                       (split.improvement + EPSILON < min_impurity_decrease));
        }
        intp node_id = tree.add_node(rec.parent, rec.is_left, is_leaf,
                                     split.feature, split.threshold,
                                     split.missing_go_to_left,
                                     parent_record.impurity,
                                     weighted_n_node_samples);
        if (node_id < 0) return -1;
        tree.value[node_id] = splitter.criterion.node_value();
        if (!is_leaf) {
            stack.push({split.pos, end, depth + 1, node_id, false,
                                split.impurity_right,
                                parent_record.n_constant_features});
            stack.push({start, split.pos, depth + 1, node_id, true,
                                split.impurity_left,
                                parent_record.n_constant_features});
        }
    }
    return tree.node_count;
}

struct FrontierRecord {
    intp node_id, start, end, pos, depth;
    bool is_leaf;
    double impurity, impurity_left, impurity_right, improvement;
};

bool compare_records(const FrontierRecord& left, const FrontierRecord& right) {
    return left.improvement < right.improvement;
}

struct BestFirst {
    Splitter& splitter;
    TreeOut& tree;
    intp min_samples_split, min_samples_leaf;
    double min_weight_leaf;
    intp max_depth;
    double min_impurity_decrease;

    // returns false when the tree's arrays are full
    bool add_split_node(intp start, intp end, bool is_first, bool is_left,
                        intp parent, intp depth, ParentInfo* parent_record,
                        FrontierRecord* res) {
        SplitRecord split;
        init_split(&split, end);
        double weighted_n_node_samples;
        splitter.node_reset(start, end, &weighted_n_node_samples);
        parent_record->n_constant_features = 0;
        if (is_first)
            parent_record->impurity = splitter.criterion.node_impurity();
        intp n_node_samples = end - start;
        bool is_leaf = (depth >= max_depth ||
                        n_node_samples < min_samples_split ||
                        n_node_samples < 2 * min_samples_leaf ||
                        weighted_n_node_samples < 2 * min_weight_leaf ||
                        parent_record->impurity <= EPSILON);
        if (!is_leaf) {
            splitter.node_split(parent_record, &split);
            is_leaf = (is_leaf || split.pos >= end ||
                       split.improvement + EPSILON < min_impurity_decrease);
        }
        intp node_id = tree.add_node(parent, is_left, is_leaf, split.feature,
                                     split.threshold,
                                     split.missing_go_to_left,
                                     parent_record->impurity,
                                     weighted_n_node_samples);
        if (node_id < 0) return false;
        tree.value[node_id] = splitter.criterion.node_value();
        res->node_id = node_id;
        res->start = start;
        res->end = end;
        res->depth = depth;
        res->impurity = parent_record->impurity;
        if (!is_leaf) {
            res->pos = split.pos;
            res->is_leaf = false;
            res->improvement = split.improvement;
            res->impurity_left = split.impurity_left;
            res->impurity_right = split.impurity_right;
        } else {
            res->pos = end;
            res->is_leaf = true;
            res->improvement = 0.0;
            res->impurity_left = parent_record->impurity;
            res->impurity_right = parent_record->impurity;
        }
        return true;
    }

    intp build(intp max_leaf_nodes) {
        std::vector<FrontierRecord> frontier;
        FrontierRecord record, split_node_left, split_node_right;
        intp max_split_nodes = max_leaf_nodes - 1;
        ParentInfo parent_record;
        if (!add_split_node(0, splitter.n_samples, true, true, TREE_UNDEFINED,
                            0, &parent_record, &split_node_left))
            return -1;
        frontier.push_back(split_node_left);
        std::push_heap(frontier.begin(), frontier.end(), compare_records);
        while (!frontier.empty()) {
            std::pop_heap(frontier.begin(), frontier.end(), compare_records);
            record = frontier.back();
            frontier.pop_back();
            intp node = record.node_id;
            bool is_leaf = record.is_leaf || max_split_nodes <= 0;
            if (is_leaf) {
                tree.left[node] = TREE_LEAF;
                tree.right[node] = TREE_LEAF;
                tree.feature[node] = TREE_UNDEFINED;
                tree.threshold[node] = TREE_UNDEFINED;
            } else {
                max_split_nodes -= 1;
                parent_record.impurity = record.impurity_left;
                if (!add_split_node(record.start, record.pos, false, true,
                                    node, record.depth + 1, &parent_record,
                                    &split_node_left))
                    return -1;
                parent_record.impurity = record.impurity_right;
                if (!add_split_node(record.pos, record.end, false, false,
                                    node, record.depth + 1, &parent_record,
                                    &split_node_right))
                    return -1;
                frontier.push_back(split_node_left);
                std::push_heap(frontier.begin(), frontier.end(),
                               compare_records);
                frontier.push_back(split_node_right);
                std::push_heap(frontier.begin(), frontier.end(),
                               compare_records);
            }
        }
        return tree.node_count;
    }
};

// _cost_complexity_prune with _AlphaPruner: the leaves of the pruned tree
void cost_complexity_prune(intp n_nodes, const intp* child_l,
                           const intp* child_r, const double* impurity,
                           const double* weighted_n_node_samples,
                           double ccp_alpha, uint8_t* leaves_in_subtree) {
    double total_sum_weights = weighted_n_node_samples[0];
    std::vector<double> r_node(n_nodes), r_branch(n_nodes, 0.0);
    std::vector<intp> parent(n_nodes, 0), n_leaves(n_nodes, 0);
    std::vector<uint8_t> candidate_nodes(n_nodes, 0), in_subtree(n_nodes, 1);
    for (intp i = 0; i < n_nodes; ++i) {
        leaves_in_subtree[i] = 0;
        r_node[i] = weighted_n_node_samples[i] * impurity[i] /
                    total_sum_weights;
    }
    std::stack<std::pair<intp, intp>> ccp_stack;  // (node, parent)
    ccp_stack.push({0, TREE_UNDEFINED});
    while (!ccp_stack.empty()) {
        auto rec = ccp_stack.top();
        ccp_stack.pop();
        intp node_idx = rec.first;
        parent[node_idx] = rec.second;
        if (child_l[node_idx] == TREE_LEAF) {
            leaves_in_subtree[node_idx] = 1;
        } else {
            ccp_stack.push({child_l[node_idx], node_idx});
            ccp_stack.push({child_r[node_idx], node_idx});
        }
    }
    for (intp leaf_idx = 0; leaf_idx < n_nodes; ++leaf_idx) {
        if (!leaves_in_subtree[leaf_idx]) continue;
        r_branch[leaf_idx] = r_node[leaf_idx];
        double current_r = r_node[leaf_idx];
        intp idx = leaf_idx;
        while (idx != 0) {
            intp parent_idx = parent[idx];
            r_branch[parent_idx] += current_r;
            n_leaves[parent_idx] += 1;
            idx = parent_idx;
        }
    }
    for (intp i = 0; i < n_nodes; ++i)
        candidate_nodes[i] = !leaves_in_subtree[i];
    intp pruned_branch_node_idx = 0;
    std::stack<intp> node_indices_stack;
    while (candidate_nodes[0]) {
        double effective_alpha = DBL_MAX;
        for (intp i = 0; i < n_nodes; ++i) {
            if (!candidate_nodes[i]) continue;
            double subtree_alpha =
                (r_node[i] - r_branch[i]) / (double)(n_leaves[i] - 1);
            if (subtree_alpha < effective_alpha) {
                effective_alpha = subtree_alpha;
                pruned_branch_node_idx = i;
            }
        }
        if (ccp_alpha < effective_alpha) break;
        node_indices_stack.push(pruned_branch_node_idx);
        while (!node_indices_stack.empty()) {
            intp node_idx = node_indices_stack.top();
            node_indices_stack.pop();
            if (!in_subtree[node_idx]) continue;
            candidate_nodes[node_idx] = 0;
            leaves_in_subtree[node_idx] = 0;
            in_subtree[node_idx] = 0;
            if (child_l[node_idx] != TREE_LEAF) {
                node_indices_stack.push(child_l[node_idx]);
                node_indices_stack.push(child_r[node_idx]);
            }
        }
        leaves_in_subtree[pruned_branch_node_idx] = 1;
        in_subtree[pruned_branch_node_idx] = 1;
        intp n_pruned_leaves = n_leaves[pruned_branch_node_idx] - 1;
        n_leaves[pruned_branch_node_idx] = 0;
        double r_diff = r_node[pruned_branch_node_idx] -
                        r_branch[pruned_branch_node_idx];
        r_branch[pruned_branch_node_idx] = r_node[pruned_branch_node_idx];
        intp node_idx = parent[pruned_branch_node_idx];
        while (node_idx != TREE_UNDEFINED) {
            n_leaves[node_idx] -= n_pruned_leaves;
            r_branch[node_idx] += r_diff;
            node_idx = parent[node_idx];
        }
    }
}

// xsf's logit: log(x / (1 - x)) away from 1/2, log1p near it
inline double xsf_logit(double x) {
    if (x < 0.3 || x > 0.65) return std::log(x / (1 - x));
    double s = 2 * (x - 0.5);
    return std::log1p(s) - std::log1p(-s);
}

inline double log1pexp(double x) {
    if (x <= -37) return std::exp(x);
    if (x <= -2) return std::log1p(std::exp(x));
    if (x <= 18) return std::log(1. + std::exp(x));
    if (x <= 33.3) return x + std::exp(-x);
    return x;
}

}  // namespace

extern "C" {

// Grow one tree on X (n_samples x n_features float32, C order) against y
// and sample_weight (float64), writing its nodes into the caller's arrays
// of `capacity` entries. max_leaf_nodes < 0 grows depth first, else best
// first. Returns the node count, or -1 when `capacity` is too small.
int64_t gbm_tree_fit(const float* X, int64_t n_samples, int64_t n_features,
                     const double* y, const double* sample_weight,
                     int64_t max_features, int64_t min_samples_split,
                     int64_t min_samples_leaf, double min_weight_leaf,
                     int64_t max_depth, int64_t max_leaf_nodes,
                     double min_impurity_decrease, uint32_t seed,
                     int64_t capacity, int64_t* left, int64_t* right,
                     int64_t* feature, double* threshold,
                     uint8_t* missing_go_to_left, double* value,
                     double* impurity, double* weighted_n_node_samples) {
    Splitter splitter;
    splitter.X = X;
    splitter.n_total = n_samples;
    splitter.n_features = n_features;
    splitter.y = y;
    splitter.sample_weight = sample_weight;
    splitter.max_features = max_features;
    splitter.min_samples_leaf = min_samples_leaf;
    splitter.min_weight_leaf = min_weight_leaf;
    splitter.rand_r_state = seed;
    splitter.init();
    TreeOut tree{capacity, 0, left, right, feature, threshold,
                 missing_go_to_left, value, impurity,
                 weighted_n_node_samples};
    if (max_leaf_nodes < 0)
        return build_depth_first(splitter, tree, min_samples_split,
                                 min_samples_leaf, min_weight_leaf, max_depth,
                                 min_impurity_decrease);
    BestFirst best_first{splitter, tree, min_samples_split, min_samples_leaf,
                         min_weight_leaf, max_depth, min_impurity_decrease};
    return best_first.build(max_leaf_nodes);
}

// Minimal cost-complexity pruning of a tree of n_nodes nodes at ccp_alpha
// (DecisionTreeRegressor._prune_tree): the pruned tree's nodes, numbered
// depth first as _build_pruned_tree adds them, go to the out_ arrays (of
// n_nodes entries); returns its node count.
int64_t gbm_tree_prune(int64_t n_nodes, const int64_t* left,
                       const int64_t* right, const int64_t* feature,
                       const double* threshold,
                       const uint8_t* missing_go_to_left, const double* value,
                       const double* impurity,
                       const double* weighted_n_node_samples,
                       double ccp_alpha, int64_t* out_left,
                       int64_t* out_right, int64_t* out_feature,
                       double* out_threshold, uint8_t* out_missing_go_to_left,
                       double* out_value, double* out_impurity,
                       double* out_weighted_n_node_samples) {
    std::vector<uint8_t> leaves_in_subtree(n_nodes);
    cost_complexity_prune(n_nodes, left, right, impurity,
                          weighted_n_node_samples, ccp_alpha,
                          leaves_in_subtree.data());
    TreeOut tree{n_nodes, 0, out_left, out_right, out_feature,
                 out_threshold, out_missing_go_to_left, out_value,
                 out_impurity, out_weighted_n_node_samples};
    struct Record {
        intp start, depth, parent;
        bool is_left;
    };
    std::stack<Record> prune_stack;
    prune_stack.push({0, 0, TREE_UNDEFINED, false});
    while (!prune_stack.empty()) {
        Record rec = prune_stack.top();
        prune_stack.pop();
        intp orig = rec.start;
        bool is_leaf = leaves_in_subtree[orig];
        if (!is_leaf && left[orig] == TREE_LEAF && right[orig] == TREE_LEAF)
            return -2;
        intp node_id = tree.add_node(rec.parent, rec.is_left, is_leaf,
                                     feature[orig], threshold[orig],
                                     missing_go_to_left[orig], impurity[orig],
                                     weighted_n_node_samples[orig]);
        if (node_id < 0) return -1;
        out_value[node_id] = value[orig];
        if (!is_leaf) {
            prune_stack.push({right[orig], rec.depth + 1, node_id, false});
            prune_stack.push({left[orig], rec.depth + 1, node_id, true});
        }
    }
    return tree.node_count;
}

// The leaf each row of X (float32, C order) reaches.
void gbm_tree_apply(const float* X, int64_t n_samples, int64_t n_features,
                    const int64_t* left, const int64_t* right,
                    const int64_t* feature, const double* threshold,
                    const uint8_t* missing_go_to_left, int64_t* out) {
    for (int64_t i = 0; i < n_samples; ++i) {
        int64_t node = 0;
        while (left[node] != TREE_LEAF) {
            float v = X[i * n_features + feature[node]];
            if (std::isnan(v))
                node = missing_go_to_left[node] ? left[node] : right[node];
            else if (v <= threshold[node])
                node = left[node];
            else
                node = right[node];
        }
        out[i] = node;
    }
}

// Half binomial loss: the negative gradient -(expit(raw) - y).
void gbm_neg_gradient_binomial(const double* y_true, const double* raw,
                               int64_t n, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        double g;
        if (raw[i] > -37) {
            double exp_tmp = std::exp(-raw[i]);
            g = ((1 - y_true[i]) - y_true[i] * exp_tmp) / (1 + exp_tmp);
        } else {
            g = std::exp(raw[i]) - y_true[i];
        }
        out[i] = -g;
    }
}

// Half multinomial loss: the negative gradient -(softmax(raw)_k - [y == k])
// for raw of shape (n, n_classes), C order.
void gbm_neg_gradient_multinomial(const double* y_true, const double* raw,
                                  int64_t n, int64_t n_classes, double* out) {
    std::vector<double> p(n_classes);
    for (int64_t i = 0; i < n; ++i) {
        const double* r = raw + i * n_classes;
        double max_value = r[0];
        double sum_exps = 0;
        for (int64_t k = 1; k < n_classes; ++k)
            if (max_value < r[k]) max_value = r[k];
        for (int64_t k = 0; k < n_classes; ++k) {
            p[k] = std::exp(r[k] - max_value);
            sum_exps += p[k];
        }
        for (int64_t k = 0; k < n_classes; ++k) {
            p[k] /= sum_exps;
            out[i * n_classes + k] = -(p[k] - (double)(y_true[i] == k));
        }
    }
}

// Exponential loss: the negative gradient -(-y exp(-raw) + (1 - y) exp(raw)).
void gbm_neg_gradient_exponential(const double* y_true, const double* raw,
                                  int64_t n, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        double tmp = std::exp(raw[i]);
        out[i] = -(-y_true[i] / tmp + (1 - y_true[i]) * tmp);
    }
}

// The pointwise losses scikit-learn computes in C: kind 0 half binomial,
// 1 half multinomial (raw of shape (n, n_classes), C order), 2 exponential.
void gbm_loss(int64_t kind, const double* y_true, const double* raw,
              int64_t n, int64_t n_classes, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        if (kind == 0) {
            out[i] = log1pexp(raw[i]) - y_true[i] * raw[i];
        } else if (kind == 1) {
            const double* r = raw + i * n_classes;
            double max_value = r[0], sum_exps = 0;
            for (int64_t k = 1; k < n_classes; ++k)
                if (max_value < r[k]) max_value = r[k];
            for (int64_t k = 0; k < n_classes; ++k)
                sum_exps += std::exp(r[k] - max_value);
            out[i] = std::log(sum_exps) + max_value;
            out[i] -= r[(int64_t)y_true[i]];
        } else {
            double tmp = std::exp(raw[i]);
            out[i] = y_true[i] / tmp + (1 - y_true[i]) * tmp;
        }
    }
}

// scipy.special.logit of each of n probabilities.
void gbm_logit(const double* p, int64_t n, double* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = xsf_logit(p[i]);
}

// The subsample mask of n_in_bag of n rows from uniform draws `rand`.
void gbm_sample_mask(const double* rand, int64_t n, int64_t n_in_bag,
                     uint8_t* mask) {
    int64_t n_bagged = 0;
    for (int64_t i = 0; i < n; ++i) {
        mask[i] = 0;
        if (rand[i] * (n - i) < (n_in_bag - n_bagged)) {
            mask[i] = 1;
            n_bagged += 1;
        }
    }
}

}  // extern "C"
